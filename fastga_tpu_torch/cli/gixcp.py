# Copied from fastga_tpu/cli/gixcp.py; imports point at fastga_tpu_torch.
"""gixcp entry point (see gixxfer.py)."""
from . import _common
from .gixxfer import main_cp as main

if __name__ == "__main__":
    _common.cli_exit(main)
