"""The port's slot train step (`make_slot_train_step`): FAME, the frozen
teacher, the slot student's forward and backward, the slot loss, AdamW."""

from harness.entries import TrainEntry


def make(cfg, traffic, seed, device):
    return TrainEntry(cfg, traffic, seed, device, hvu=False)
