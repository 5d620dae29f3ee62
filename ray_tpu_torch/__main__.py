"""`python -m ray_tpu <command>` → the cluster CLI."""

import sys

from ray_tpu_torch.scripts.cli import main

sys.exit(main())
