"""Invocation alias of cli.main_other (as xtagclip_tpu/cli/main_other_simple.py):
the reference keeps main_other.py and main_other_simple.py as near
duplicates; one CLI carries their union, and this module keeps
``python -m xtagclip_tpu_torch.cli.main_other_simple`` working."""

from xtagclip_tpu_torch.cli.main_other import main

if __name__ == "__main__":
    import sys

    main(sys.argv[1:])
