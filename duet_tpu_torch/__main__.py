"""`python -m duet_tpu_torch BAM REF OUT [flags]` — same as duet-tpu-torch."""

import sys

from duet_tpu_torch.cli import main

sys.exit(main())
