"""fcvsr_tpu_torch - FCVSR inference and training, and EDVR / BasicVSR++
serving and training, in PyTorch, with hand-written CUDA kernels for an
NVIDIA Hopper GPU (H100).

The port of ``fcvsr_tpu`` (JAX, the reference it is tested against; the
port imports nothing of it):

  ops/     channels-last functional ops, and the wrappers of the CUDA
           kernels (``fused_iac``, ``fused_conv``, ``fused_dcn``,
           ``fused_blockrcb``), each beside its plain PyTorch version, with
           the autograd Functions that train through them
  csrc/    the CUDA sources, built with nvcc for sm_90a at first use
  benchmarks/  the BlockRCB level A/B (fused kernel against the unfused
           path)
  tools/   the GPU toolchain probe (``python -m fcvsr_tpu_torch.tools.gpu_probe``)
  models/  FCVSRNet (full and -S) with reference state_dict keys; EDVRNet,
           BasicVSRPlusPlus and SpyNet with mmedit's; the registry; the
           restorer that trains and evaluates the zoo (VideoRestorer)
  train/   losses, LR schedules, the train state and step, and the training
           entry point (``python -m fcvsr_tpu_torch.train.cli``)
  data/    clip folders, windows and sequences, crops and flips (numpy)
  metrics/ PSNR / SSIM / tOF (numpy)
  utils/   presets, checkpoints, weight conversion from the JAX params
  apis.py  video inference: sliding windows, or a recurrent model over the
           whole clip
  cli.py   evaluation / FPS entry point (``python -m fcvsr_tpu_torch.cli``)

Importing the package builds and loads nothing: the kernel library is made
at the first launch on a CUDA tensor.
"""

__version__ = "0.1.0"
