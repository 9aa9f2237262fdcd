"""The benchmark's own code: traffic, the yardstick and the trace reduction.

Nothing here imports the program (``pycollo_tpu_torch``) at module level;
``run.py`` does, and only it drives the program.
"""
