"""Counterpart of ``tools/test_Vid4_FCVSR.py``: serves preset
``fcvsr_redsLD_QP37`` through ``fcvsr_tpu_torch.cli`` (sliding-window PSNR /
SSIM / tOF); every other flag passes through, ``--device cpu`` for the CPU (the
card by default).

    python -m fcvsr_tpu_torch.tools.test_Vid4_FCVSR \
        --lr-root LR --gt-root GT [flags]
"""

from . import pinned

PRESET = "fcvsr_redsLD_QP37"


def main(argv=None) -> dict:
    return pinned.test(PRESET, argv)


if __name__ == "__main__":
    main()
