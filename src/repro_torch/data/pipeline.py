"""Host-side batching utilities of the loop engine (numpy only)."""
from __future__ import annotations

from typing import Dict, List

import numpy as np


def make_batches(n: int, batch_size: int) -> List[np.ndarray]:
    """Contiguous index batches [0..n), the last one ragged. The FL sim
    scores and sorts these."""
    ids = np.arange(n)
    return [ids[i : i + batch_size] for i in range(0, n, batch_size)]


def gather_batch(data: Dict[str, np.ndarray], idx: np.ndarray) -> Dict[str, np.ndarray]:
    return {k: v[idx] for k, v in data.items()}
