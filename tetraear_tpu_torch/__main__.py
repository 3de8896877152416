import sys

from tetraear_tpu_torch.cli import main

sys.exit(main())
