import sys

from yolo_from_scratch_tpu_torch.cli import main

sys.exit(main())
