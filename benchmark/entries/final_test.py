"""The port's eval protocol (`eval/protocols.py::final_test`) on the
`--eval_scene` path: the student's scene logits, the teacher's argmax."""

from harness.entries import FinalTestEntry


def make(cfg, traffic, seed, device):
    return FinalTestEntry(cfg, traffic, seed, device)
