"""The pinned scripts' one entry: each ``train_FCVSR*_*`` and
``test_*_FCVSR*`` module of this package pins one preset, as the reference
ships one script a configuration, and hands every other argument to the
port's training CLI (``fcvsr_tpu_torch.train.cli``) or serving CLI
(``fcvsr_tpu_torch.cli``).  Both run on the card unless ``--device cpu``
is among the arguments."""

from __future__ import annotations

import sys

__all__ = ["train", "test"]


def _argv(argv) -> list:
    return list(sys.argv[1:] if argv is None else argv)


def train(preset: str, argv=None) -> dict:
    """``train.cli.main`` with ``--preset preset`` and ``argv`` (default:
    the command line's arguments)."""
    from ..train import cli

    return cli.main(["--preset", preset] + _argv(argv))


def test(preset: str, argv=None) -> dict:
    """``cli.main`` with ``--preset preset`` and ``argv`` (default: the
    command line's arguments)."""
    from .. import cli

    return cli.main(["--preset", preset] + _argv(argv))
