# Copied from fastga_tpu/cli/gixmv.py; imports point at fastga_tpu_torch.
"""gixmv entry point (see gixxfer.py)."""
from . import _common
from .gixxfer import main_mv as main

if __name__ == "__main__":
    _common.cli_exit(main)
