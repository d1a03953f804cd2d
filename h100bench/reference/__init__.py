"""The benchmark's plain reference: FCVSR / FCVSR-S's forward
(:mod:`.fcvsr`) and the CVCP training recipe (:mod:`.train`) in plain
PyTorch.  It imports nothing of the measured program."""
