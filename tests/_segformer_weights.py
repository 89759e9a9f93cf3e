"""Segformer weights for the port's tests, torch and numpy only: the tiny
geometry of `tests/test_segformer.py` (four stages, sr ratios > 1) and an
HF-layout state dict of it drawn from a seed."""

import numpy as np
import torch

from devias_tpu_torch.nn.segformer import SegformerConfig, create_segformer

GEOMETRY = dict(num_labels=19, hidden_sizes=(16, 32, 80, 128), depths=(1, 1, 2, 1), num_heads=(1, 2, 5, 8),
                decoder_hidden_size=64)
TINY = SegformerConfig(**GEOMETRY)


def hf_state_dict(seed=0, person_bias=0.0):
    """An HF-layout state dict of TINY (the port's keys and shapes) drawn
    from `seed`: weights at 1/sqrt(fan-in), norms near one, biases and
    BatchNorm statistics away from their identity values, and the person
    class's bias raised by `person_bias`."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in create_segformer(TINY, device="cpu").state_dict().items():
        shape = tuple(v.shape)
        if k.endswith("num_batches_tracked"):
            sd[k] = v
            continue
        if k.endswith("running_var"):
            x = rng.uniform(0.5, 2.0, shape)
        elif k.endswith("running_mean") or k.endswith("bias"):
            x = rng.normal(0, 0.1 if k.endswith("bias") else 0.5, shape)
        elif len(shape) == 1:  # a norm's scale
            x = 1.0 + 0.1 * rng.normal(size=shape)
        else:
            x = rng.normal(0, np.prod(shape[1:]) ** -0.5, shape)
        sd[k] = torch.from_numpy(x.astype(np.float32))
    sd["decode_head.classifier.bias"][11] += person_bias
    return sd
