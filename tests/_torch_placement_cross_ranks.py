"""Rank bodies for the audio and vision families' parameter-placement
tests (``tests/test_torch_placement_cross.py``): whisper-medium and
llama-3.2-vision-90b through the suites of
``tests/_torch_placement_recurrent_ranks.py``.

Each function runs in every rank of a group of four that
``repro_torch.launch.mesh.spawn`` starts on the ``gloo`` backend (CPU), as
the (data 2, model 2) mesh.  This module imports no ``jax``.
"""

from _torch_placement_recurrent_ranks import VISION, WHISPER, serve_suite, train_suite

SERVE_ARCHS = (WHISPER, VISION)
TRAIN_CASES = [(WHISPER, "digital"), (VISION, "digital"), (VISION, "ideal")]


def suite(rank, world, params_np):
    """The serve and train suites of whisper-medium and
    llama-3.2-vision-90b in one group."""
    return {"serve": serve_suite(SERVE_ARCHS, params_np), "train": train_suite(TRAIN_CASES, params_np)}
