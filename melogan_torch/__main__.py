"""``python -m melogan_torch`` → the CLI (``melogan_torch/cli.py``)."""
from melogan_torch.cli import main

if __name__ == "__main__":
    main()
