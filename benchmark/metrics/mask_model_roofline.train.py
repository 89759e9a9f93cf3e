"""Share of the mask model's roofline in a profiled train step: the least time of its forward on the step's masked frames (`models/<mask model>.py::bound_ms`: operations at the bf16 peak or least bytes at HBM bandwidth) over its device span's ms, %; None where that span reads nothing."""

from harness import spec


def read(run):
    ms = spec.reader("mask_model_ms.train")(run)
    if not ms:
        return None
    m, mm = run["config"]["model"], run["config"]["mask_model"]
    frames = run["traffic"]["batch"] * (m["num_frames"] // 2)
    return spec.model(mm["name"]).bound_ms(mm, frames, m["img_size"]) / ms * 100.0
