"""Tools that run on the card beside ``chip_smoke.py``: ``gemm_ab`` and
``step_ab`` time kernels and train steps of several source trees side by
side; ``learning_proof`` (on ``proof_corpus``'s synthetic pieces) trains,
transcribes and scores the reduced recipe end to end."""
