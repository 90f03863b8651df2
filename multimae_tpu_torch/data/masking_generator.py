"""Host-side random masking generator (counterpart of
multimae_tpu/data/masking_generator.py; reference
utils/masking_generator.py:11-33).

Kept for completeness: the reference defines it but never imports it;
MultiMAE masks inside the model (ops/masking.py).
"""

from __future__ import annotations

import numpy as np


class RandomMaskingGenerator:
    def __init__(self, input_size, mask_ratio: float):
        if not isinstance(input_size, tuple):
            input_size = (input_size,) * 2
        self.height, self.width = input_size
        self.num_patches = self.height * self.width
        self.num_mask = int(mask_ratio * self.num_patches)

    def __repr__(self):
        return f"Mask: total patches {self.num_patches}, mask patches {self.num_mask}"

    def __call__(self):
        mask = np.hstack([
            np.zeros(self.num_patches - self.num_mask),
            np.ones(self.num_mask),
        ])
        np.random.shuffle(mask)
        return mask
