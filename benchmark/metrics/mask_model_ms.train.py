"""Device ms of the mask model in a profiled train step: the program's device span `train.mask_model` (the SegFormer's person masks of the even frames, timed by CUDA events the step's graph records on every replay), its last interval; None where the program has no such span or ran off the card."""


def read(run):
    if run["record"]["kind"] != "train" or run.get("profile") is None:
        return None
    return run["profile"].get("mask_model_ms")
