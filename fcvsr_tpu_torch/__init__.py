"""fcvsr_tpu_torch - FCVSR inference in PyTorch, with hand-written CUDA
kernels for an NVIDIA Hopper GPU (H100).

The port of ``fcvsr_tpu`` (JAX, the reference it is tested against):

  ops/     channels-last functional ops, and the wrappers of the CUDA
           kernels (``fused_iac``, ``fused_conv``), each beside its plain
           PyTorch version
  csrc/    the CUDA sources, built with nvcc for sm_90a at first use
  models/  FCVSRNet (full and -S) with reference state_dict keys
  utils/   weight conversion from the JAX package's params
  apis.py  sliding-window video inference
  cli.py   evaluation / FPS entry point (``python -m fcvsr_tpu_torch.cli``)

Importing the package builds and loads nothing: the kernel library is made
at the first launch on a CUDA tensor.
"""

__version__ = "0.1.0"
