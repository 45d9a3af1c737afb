# Copied from fastga_tpu/_version.py.
VERSION = "0.1.0"
