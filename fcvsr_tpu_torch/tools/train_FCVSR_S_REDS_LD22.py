"""Counterpart of ``tools/train_FCVSR_S_REDS_LD22.py``: trains preset
``fcvsr_s_redsLD_QP22`` through ``fcvsr_tpu_torch.train.cli``; every other flag
passes through, ``--device cpu`` for the CPU (the card by default).

    python -m fcvsr_tpu_torch.tools.train_FCVSR_S_REDS_LD22 \
        --lr-root LR --gt-root GT [flags]
"""

from . import pinned

PRESET = "fcvsr_s_redsLD_QP22"


def main(argv=None) -> dict:
    return pinned.train(PRESET, argv)


if __name__ == "__main__":
    main()
