"""The run's logger: the console and a timestamped file in the work
directory on rank 0, silent on the other ranks (the JAX package's
``utils/logging_utils.py``)."""
from __future__ import annotations

import logging
import time
from pathlib import Path
from typing import Optional

from sassd_tpu_torch.parallel import dist


def get_root_logger(work_dir: Optional[str] = None,
                    level=logging.INFO) -> logging.Logger:
    """The "sassd" logger, set up on its first call (later calls return
    it as it is). Rank 0 (dist.process_index(), 0 without a process
    group) logs to the console and, with `work_dir`, to
    ``work_dir/{YYYYmmdd_HHMMSS}.log``; other ranks log nothing."""
    logger = logging.getLogger("sassd")
    if logger.handlers:
        return logger
    logger.setLevel(level)
    fmt = logging.Formatter("%(asctime)s - %(levelname)s - %(message)s")
    if dist.process_index() == 0:
        sh = logging.StreamHandler()
        sh.setFormatter(fmt)
        logger.addHandler(sh)
        if work_dir:
            Path(work_dir).mkdir(parents=True, exist_ok=True)
            ts = time.strftime("%Y%m%d_%H%M%S", time.localtime())
            fh = logging.FileHandler(str(Path(work_dir) / f"{ts}.log"))
            fh.setFormatter(fmt)
            logger.addHandler(fh)
    else:
        logger.addHandler(logging.NullHandler())
        logger.propagate = False
    return logger
