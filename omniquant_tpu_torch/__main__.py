"""``python -m omniquant_tpu_torch``: the command line (``cli.py``)."""
from .cli import main

if __name__ == "__main__":
    main()
