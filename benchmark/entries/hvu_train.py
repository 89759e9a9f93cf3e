"""The port's HVU train step (`make_hvu_train_step`): FAME-HVU, the slot
student's forward and backward against real scene labels, no teacher."""

from harness.entries import TrainEntry


def make(cfg, traffic, seed, device):
    return TrainEntry(cfg, traffic, seed, device, hvu=True)
