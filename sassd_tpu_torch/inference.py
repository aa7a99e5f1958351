"""Inference step: a host batch in, detections out."""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from sassd_tpu_torch.config import SASSDConfig, check_supported
from sassd_tpu_torch.models.detector import Detector


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """numpy batch -> tensors on `device` (plans stay int16 on the wire)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def make_test_step(cfg: SASSDConfig, anchors: np.ndarray, device
                   ) -> Callable[[Detector, Dict[str, np.ndarray]],
                                 Dict[str, torch.Tensor]]:
    """Returns step(model, batch) -> detections on `device` (not synced)."""
    check_supported(cfg)
    anchors_t = torch.from_numpy(np.asarray(anchors, np.float32)).to(device)

    def step(model: Detector, batch: Dict[str, np.ndarray]):
        return model.forward_test(to_device(batch, device), anchors_t)
    return step
