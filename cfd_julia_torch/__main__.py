import sys

from cfd_julia_torch.cli import main

sys.exit(main())
