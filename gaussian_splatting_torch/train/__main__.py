"""``python -m gaussian_splatting_torch.train``: see ``train/cli.py``."""

from gaussian_splatting_torch.train.cli import main

if __name__ == "__main__":
    main()
