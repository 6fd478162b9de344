"""``python -m chaorec_tpu_torch``: the port's command line (``cli.py``)."""

from chaorec_tpu_torch.cli import main

if __name__ == "__main__":
    main()
