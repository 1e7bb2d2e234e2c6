import sys

from .main import main

# guarded: importing the module (as a walk over the package does) must
# not run the CLI
if __name__ == "__main__":
    sys.exit(main())
