"""Program of `tests/test_torch_kill_resume.py` (on the CPU, `--device
cpu`) and of `chip_smoke.py`'s kill_resume phase (on the card): one
process of the port's `run_slot_finetuning`, argv passed through, torch
on one host thread. With `DEVIAS_KILL_AT` set it stops at a fixed point, writes the
marker file `DEVIAS_KILL_MARKER` and waits there for the parent's
SIGKILL:

- `step:N`: before the train step of 0-based call N;
- `save:E`: inside the write of epoch E's checkpoint, once the first half
  of its temporary file is on disk.

Without it the process runs to its end (the uninterrupted run and the
relaunch).
"""

import io
import os
import sys
import time

import torch

torch.set_num_threads(1)

from devias_tpu_torch.cli import run_slot_finetuning as cli  # noqa: E402


def _stop_here() -> None:
    with open(os.environ["DEVIAS_KILL_MARKER"], "w") as f:
        f.write(str(os.getpid()))
    while True:
        time.sleep(60)


def _stop_at_step(n: int) -> None:
    make = cli.make_slot_train_step

    def make_stopping(*args, **kwargs):
        step = make(*args, **kwargs)
        calls = [0]

        def stopping(*a, **kw):
            if calls[0] == n:
                _stop_here()
            calls[0] += 1
            return step(*a, **kw)

        return stopping

    cli.make_slot_train_step = make_stopping


def _stop_in_save(epoch: int) -> None:
    save = torch.save

    def half_save(obj, f, *args, **kwargs):
        name = os.path.basename(str(f))
        if not (name.startswith(f"checkpoint-{epoch}.pth.") and name.endswith(".tmp")):
            return save(obj, f, *args, **kwargs)
        buf = io.BytesIO()
        save(obj, buf, *args, **kwargs)
        data = buf.getvalue()
        with open(f, "wb") as out:
            out.write(data[:len(data) // 2])
            out.flush()
            os.fsync(out.fileno())
        _stop_here()

    torch.save = half_save


if __name__ == "__main__":
    kind, _, at = os.environ.get("DEVIAS_KILL_AT", "").partition(":")
    if kind == "step":
        _stop_at_step(int(at))
    elif kind == "save":
        _stop_in_save(int(at))
    cli.main(cli.get_args(sys.argv[1:]))
