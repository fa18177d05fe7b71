"""Data of the port: ``pipeline``, the reference's numpy-only pipeline,
copied (``tests/test_torch_sched_copies.py`` holds it to the reference)."""
