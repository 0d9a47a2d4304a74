"""`python -m tpumil_torch.cli` — list the available entry points."""

import sys

from tpumil_torch.cli import __doc__ as listing


def main():
    print(listing)
    return 0


if __name__ == "__main__":
    sys.exit(main())
