"""Benchmarks of the port that no serving or training path runs
(``python -m fcvsr_tpu_torch.benchmarks.<name>``)."""
