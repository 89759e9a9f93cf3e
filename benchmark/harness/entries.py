"""The kinds of step a traffic mix can drive, which the files of
`entries/` build by name: a train step of the port (`TrainEntry`) and its
eval protocol (`FinalTestEntry`). Each builds the program from a
configuration and a seed, warms it up, runs a measured window, profiles a
few more calls, and judges what the timed path produced against the plain
reference once the program is gone. Each model of the configuration is
built, and its reference, tokens and operations found, by its name
through `models/<name>.py`.

The program is `devias_tpu_torch`; the benchmark hands it weights, clips,
labels and draws it makes itself from the seed, and reads back only what
the program returns: its metrics, its optimizer's state, its parameters
and the rows `final_test` writes.
"""

from __future__ import annotations

import contextlib
import math
import os
import re
import shutil
import statistics
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from harness import roofline, spec
from harness.profile import profile_calls
from harness.spans import program_spans
from harness.weights import DROP_STREAM, generator, load_into, make_pool, make_weights, shapes_of
from reference import model as ref_model
from reference import train as ref_train
from reference.optim import schedule

LOSS_KEYS = ("loss", "action_loss", "scene_loss", "cosine_loss", "mask_prediction_loss", "mask_distill_loss")
CHECKED_STEPS = 3
# rows of a batch the reference runs at once
REF_ROWS = 4
# steps a traced train run makes before it reads the program's spans in the
# steady state: more than the replays the program keeps in flight (two,
# `train/graph.py`), so that each later step waits as the window's steps do
STEADY_LEAD = 4


def program_kwargs(m: dict) -> dict:
    """A model entry of the configuration as the port's constructor takes
    it: every key but `name`, the compute type as a torch dtype."""
    kw = {k: v for k, v in m.items() if k != "name"}
    kw["dtype"] = getattr(torch, m["dtype"])
    return kw


def build_program(cfg: dict, device, weights):
    """The port's student (and teacher, where the configuration has one),
    made on `device` by its model file and given `weights`, in eval mode."""
    out = []
    for key in ("model", "teacher"):
        m = cfg.get(key)
        if not m:
            out.append(None)
            continue
        net = spec.model(m["name"]).program(m, device)
        load_into(net, weights[key])
        out.append(net.eval())
    return out


def model_shapes(cfg: dict) -> Dict[str, Dict[str, tuple]]:
    """The reference's parameter names and shapes of every model of the
    configuration: what the weights are drawn for."""
    return {key: shapes_of(spec.model(cfg[key]["name"]).reference(cfg[key]).named_parameters())
            for key in ("model", "teacher") if cfg.get(key)}


def step_gaps_ms(events: List[torch.cuda.Event]) -> List[float]:
    return [a.elapsed_time(b) for a, b in zip(events, events[1:])]


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], leaves: List[str]) -> Dict[str, float]:
    """Per leaf, the gap between the program's norm and the reference's,
    against the reference's norm of that leaf or of the median leaf,
    whichever is larger."""
    median = statistics.median(ref[k] for k in leaves)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], median) for k in leaves}


def moved_leaves(ref: dict) -> List[str]:
    """The leaves whose reference gradient is at least a thousandth of the
    median leaf's: the others move by round-off alone under Adam."""
    gmed = statistics.median(ref["grad_norms"].values())
    return [k for k, v in ref["grad_norms"].items() if v >= 1e-3 * gmed]


def resolve_near_ties(prog: dict, ref: dict, leaves: List[str]) -> dict:
    """The reference's first step with its near-ties resolved nearest to
    the program's gradients: of every subset of the near-tie samples
    taking their other slot assignment, the one with the least sum over
    leaves of the squared `leaf_gaps`. The search is whole, not local (a
    batch whose teacher argmax is near a tie on every sample has 2**12
    subsets, and toggling one at a time stops short of the program's): each
    subset's leaf norms come from the leaf's Gram matrix of the first
    step's gradient and the near-ties' changes. Returns {"terms",
    "grad_norms", "swapped"}."""
    first = ref["first_step"]
    near = first["near"]
    n = len(near)
    subsets = (torch.arange(2 ** n)[:, None] >> torch.arange(n)) & 1
    X = torch.cat([torch.ones(2 ** n, 1, dtype=torch.long), subsets], 1).double()
    sq = []
    for k in leaves:
        g = first["grads"][k]
        V = torch.stack([g.flatten()] + [(t["grads"][k] if t["grads"][k] is not None else torch.zeros_like(g)).flatten()
                                         for t in near]).double()
        G = (V @ V.T).cpu()
        sq.append(((X @ G) * X).sum(1))
    norms = torch.stack(sq, 1).clamp_min(0).sqrt()
    median = torch.quantile(norms, 0.5, dim=1, keepdim=True)
    p = torch.tensor([prog["grad_norms"][k] for k in leaves], dtype=torch.float64)
    cost = ((p - norms).abs() / torch.maximum(norms, median)).pow(2).sum(1)
    chosen = [t for t, b in zip(near, subsets[int(cost.argmin())].tolist()) if b]
    grads = dict(first["grads"])
    terms = dict(first["terms"])
    for tie in chosen:
        grads = {k: g if tie["grads"][k] is None else g + tie["grads"][k] for k, g in grads.items()}
        for k, v in tie["terms"].items():
            terms[k] += v
    terms["loss"] = sum(v for k, v in terms.items() if k != "loss" and k in LOSS_KEYS)
    return {"terms": terms, "grad_norms": {k: float(g.norm()) for k, g in grads.items()},
            "swapped": [t["sample"] for t in chosen]}


def train_gaps(prog: dict, ref: dict) -> Dict[str, float]:
    """The train cells' numbers, each against the reference's loss or norm.
    The first step's, against the reference's first step with its
    near-ties resolved (`resolve_near_ties`): loss1_gap, the largest gap
    of the loss and its terms; grad_gap, the worst of `leaf_gaps` of the
    gradients. Along the reference's own steps: loss_gap, the largest gap
    over every checked step; change_gap, the worst leaf's change after the
    last. Leaves: `moved_leaves`."""
    leaves = moved_leaves(ref)
    first = resolve_near_ties(prog, ref, leaves)
    p1 = prog["steps"][0]
    return {"loss1_gap": max(abs(p1[k] - first["terms"][k]) / abs(first["terms"]["loss"]) for k in LOSS_KEYS),
            "grad_gap": max(leaf_gaps(prog["grad_norms"], first["grad_norms"], leaves).values()),
            "loss_gap": max(abs(p[k] - r[k]) / abs(r["loss"]) for p, r in zip(prog["steps"], ref["steps"])
                            for k in LOSS_KEYS),
            "change_gap": max(leaf_gaps(prog["change_norms"], ref["change_norms"], leaves).values())}


def judge(numbers: Dict[str, float], limits: Dict[str, Optional[float]]) -> Dict:
    """{name: {value, limit}} for every compared number, and whether each
    finite number is within its limit. A limit of null marks a number that
    is reported and not compared."""
    compared = {k: {"value": v, "limit": limits.get(k)} for k, v in numbers.items()}
    ok = all(math.isfinite(c["value"]) and (c["limit"] is None or c["value"] <= c["limit"])
             for c in compared.values())
    return {"correct": ok, "compared": compared}


class TrainEntry:
    """The slot train step (`make_slot_train_step`) or, with `hvu`, the HVU
    step (`make_hvu_train_step`), closed loop over the traffic's pool of
    batches, each with its own FAME draws; drop-path draws from one
    generator of the seed. Set-up's first CHECKED_STEPS steps are the
    checked ones (pool batches 0, 1, 2: every row different), then the
    traffic's `warm_steps` more."""

    kind = "train"

    def __init__(self, cfg: dict, traffic: dict, seed: int, device, hvu: bool):
        from devias_tpu_torch.aug import FAMEConfig
        from devias_tpu_torch.losses import SlotLossConfig
        from devias_tpu_torch.train import (OptimConfig, TrainState, TrainStepConfig, make_hvu_train_step,
                                            make_optimizer, make_slot_train_step)

        if traffic["pool"] < CHECKED_STEPS:
            raise ValueError(f"a train pool needs {CHECKED_STEPS} batches or more for the checked steps")
        self.cfg, self.traffic, self.seed, self.device, self.hvu = cfg, traffic, seed, torch.device(device), hvu
        self.B = traffic["batch"]
        self.shapes = model_shapes(cfg)
        weights = make_weights(self.shapes, seed, self.device)
        self.model, self.teacher = build_program(cfg, self.device, weights)
        del weights
        o, m = cfg["optim"], cfg["model"]
        sched = schedule(o)
        self.opt, lr_fn = make_optimizer(self.model, OptimConfig(
            lr=sched["lr"], min_lr=o["min_lr"], warmup_lr=o["warmup_lr"], weight_decay=o["weight_decay"],
            layer_decay=o["layer_decay"], agg_block_scale=o["agg_block_scale"], num_layers=m["depth"],
            total_steps=sched["total_steps"], warmup_steps=sched["warmup_steps"]), device=self.device)
        self.state = TrainState.create(self.model, self.opt, device=self.device)
        loss_cfg = SlotLossConfig(num_action_classes=m["num_classes"], num_scene_classes=m["num_scene_classes"],
                                  **cfg["loss"])
        step_cfg = TrainStepConfig(use_fame=True, fame=FAMEConfig(beta=cfg["fame"]["beta"],
                                                                  prob_aug=cfg["fame"]["prob_aug"]))
        if hvu:
            self.step = make_hvu_train_step(self.model, self.opt, loss_cfg, step_cfg, lr_fn, device=self.device)
        else:
            self.step = make_slot_train_step(self.model, self.teacher, self.opt, loss_cfg, step_cfg, lr_fn,
                                             device=self.device)
        self.pool = make_pool(traffic, cfg, seed, self.device)
        self.drop_gen = generator(seed, DROP_STREAM, self.device)
        self.calls = 0
        self.metrics = None

    def call(self) -> Dict:
        """One step on the next pool batch."""
        i = self.calls % self.traffic["pool"]
        batch = {"videos": self.pool["videos"][i], "labels": self.pool["labels"][i]}
        if self.hvu:
            batch["scene_labels"] = self.pool["scene_labels"][i]
        self.calls += 1
        self.metrics = self.step(self.state, batch, generator=self.drop_gen,
                                 draws={"perm": self.pool["perm"][i], "keep": self.pool["keep"][i]})
        return self.metrics

    def setup(self) -> None:
        """The checked steps, read as the optimizer and the parameters hold
        them, then the warm-up steps."""
        steps = []
        for s in range(CHECKED_STEPS):
            metrics = self.call()
            steps.append({k: float(metrics[k]) for k in LOSS_KEYS})
            if s == 0:
                b1 = self.opt.cfg.beta1
                grads = {n: float(self.opt.state[p]["exp_avg"].norm()) / (1 - b1)
                         for n, p in self.model.named_parameters()}
        w0 = make_weights(self.shapes, self.seed, self.device)["model"]
        with torch.no_grad():
            change = {n: float((p - w0[n]).norm()) for n, p in self.model.named_parameters()}
        del w0
        self.readings = {"steps": steps, "grad_norms": grads, "change_norms": change}
        for _ in range(self.traffic.get("warm_steps", 0)):
            self.call()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def window(self, seconds: float) -> Dict:
        """Steps until `seconds` have passed, with a CUDA event after each
        and no synchronize until the end."""
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        events, host_s = [], []
        if cuda:
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            h0 = time.perf_counter()
            self.call()
            host_s.append(time.perf_counter() - h0)
            if cuda:
                events.append(torch.cuda.Event(enable_timing=True))
                events[-1].record()
        if cuda:
            torch.cuda.synchronize(self.device)
        wall = time.perf_counter() - t0
        steps = len(host_s)
        return {"kind": self.kind, "steps": steps, "clips": steps * self.B, "wall_s": wall, "window_start": t0,
                "step_ms": step_gaps_ms(events) if cuda else [], "host_ms": [s * 1e3 for s in host_s],
                "peak_bytes": torch.cuda.max_memory_allocated(self.device) if cuda else 0,
                "finite": math.isfinite(float(self.metrics["loss"])),
                "flops_per_clip": roofline.flops_per_clip(self.cfg, train=True), "batch": self.B}

    def profile(self, n: int) -> Dict:
        """`n` steps in the steady state under a host-only profiler (the
        program's spans there, `steady`), then `n` steps traced from a
        synchronize (`profile_calls`)."""
        from devias_tpu_torch.kernels import attention

        steady = self.steady_spans(n)
        prof = profile_calls(self.call, n, n, attention.launch_counts, attention.reset_launch_counts,
                             self.device.type == "cuda")
        return {**prof, "steady": steady}

    def steady_spans(self, n: int) -> Optional[Dict]:
        """The program's spans over `n` steps that run as the window's do:
        under a host-only profiler with no synchronize, the tally after
        STEADY_LEAD + n steps less the tally after STEADY_LEAD (a
        synchronize empties the replays in flight, so the first steps after
        one wait less). One unprofiled step follows, so that the traced
        steps' first span starts the program's tally anew. None where the
        program keeps no tally."""
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU]):
            for _ in range(STEADY_LEAD):
                self.call()
            before = program_spans()
            for _ in range(n):
                self.call()
            after = program_spans()
        self.call()
        if after is None:
            return None
        return {"units": n, "spans": {k: {f: v[f] - before.get(k, {}).get(f, 0) for f in v}
                                      for k, v in after.items()}}

    def release(self) -> None:
        """Free the program's state: models, optimizer, step."""
        del self.model, self.teacher, self.opt, self.state, self.step, self.metrics
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_readings(self, quant: Optional[str] = None, half: bool = False) -> Dict:
        """The reference over the checked steps, from the same weights,
        clips, labels and draws."""
        batches, keeps = [], []
        g = generator(self.seed, DROP_STREAM, self.device)
        for s in range(CHECKED_STEPS):
            batches.append({k: v[s] for k, v in self.pool.items()})
            keeps.append({i: tuple((torch.rand((self.B, 1, 1), generator=g, device=self.device) < 1.0 - r).view(-1)
                                   for _ in range(2))
                          for i, r in ref_model.drop_keep_shapes(self.cfg["model"])})
        weights = make_weights(self.shapes, self.seed, self.device)
        return ref_train.run_train(self.cfg, weights, batches, keeps, self.device, REF_ROWS, quant, half)

    def check(self, limits: dict) -> Dict:
        with reference_precision():
            ref = self.reference_readings()
        return judge(train_gaps(self.readings, ref), limits)


class FinalTestEntry:
    """`eval/protocols.py::final_test` on the `--eval_scene` path: the
    student's scene logits, the teacher's argmax as the target, over a
    loader that cycles the traffic's pool of host batches until the
    window's deadline; the result file under a temporary directory of
    TMPDIR, removed at the end."""

    kind = "eval"

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        from devias_tpu_torch.train import make_eval_step

        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, torch.device(device)
        self.B, self.P = traffic["batch"], traffic["pool"]
        weights = make_weights(model_shapes(cfg), seed, self.device)
        self.model, self.teacher = build_program(cfg, self.device, weights)
        del weights
        pool = make_pool(traffic, cfg, seed, self.device)
        self.host = pool["videos"].cpu().numpy()
        del pool
        self.A = cfg["model"]["num_classes"]
        scene_step = make_eval_step(self.model, "scene_logit", self.device)
        teacher_step = make_eval_step(self.teacher, "logits", self.device)
        self.host_s: List[float] = []

        def spans(fn):
            def timed(videos):
                h0 = time.perf_counter()
                out = fn(videos)
                self.host_s.append(time.perf_counter() - h0)
                return out
            return timed

        self.scene_fn = spans(lambda v: scene_step(v)[:, self.A:])
        self.teacher_fn = spans(teacher_step)
        self.out_dir = tempfile.mkdtemp(prefix="bench_eval_rows_")
        self.batches = 0

    def loader(self, deadline: float, limit: Optional[int] = None):
        """Batches of the pool, in turn, until the deadline (or `limit`)."""
        i = 0
        zeros = np.zeros(self.B, np.int64)
        while time.perf_counter() < deadline and (limit is None or i < limit):
            yield {"videos": self.host[i % self.P], "video_id": [f"{i}_{r}" for r in range(self.B)],
                   "chunk": zeros, "split": zeros}
            i += 1
        self.batches = i

    def run(self, deadline: float, limit: Optional[int] = None, out_dir: Optional[str] = None) -> None:
        from devias_tpu_torch.eval import final_test

        final_test(self.loader(deadline, limit), self.scene_fn, self.B, out_dir or self.out_dir,
                   scene_label_fn=self.teacher_fn, device=self.device)

    def setup(self) -> None:
        self.run(math.inf, limit=self.traffic.get("warm_batches", 2))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def window(self, seconds: float) -> Dict:
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        self.host_s = []
        t0 = time.perf_counter()
        self.run(t0 + seconds)
        if cuda:
            torch.cuda.synchronize(self.device)
        wall = time.perf_counter() - t0
        self.window_batches = self.batches
        return {"kind": self.kind, "batches": self.batches, "clips": self.batches * self.B, "wall_s": wall,
                "window_start": t0,
                "host_ms": [s * 1e3 for s in self.host_s], "peak_bytes":
                    torch.cuda.max_memory_allocated(self.device) if cuda else 0, "finite": True,
                "flops_per_clip": roofline.flops_per_clip(self.cfg, train=False), "batch": self.B}

    def profile(self, n: int) -> Dict:
        from devias_tpu_torch.kernels import attention

        side = os.path.join(self.out_dir, "profiled")
        return profile_calls(lambda: self.run(math.inf, limit=n, out_dir=side), 1, n, attention.launch_counts,
                             attention.reset_launch_counts, self.device.type == "cuda")

    def release(self) -> None:
        del self.model, self.teacher, self.scene_fn, self.teacher_fn
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def rows(self) -> Dict[str, tuple]:
        """The window's result file: {id: (logits, label)}."""
        rows = {}
        with open(os.path.join(self.out_dir, "0.txt")) as f:
            next(f)
            for line in f:
                m = re.match(r"^(\S+) \[(.*)\] (-?\d+) (-?\d+) (-?\d+)$", line.strip())
                if m is None:
                    raise ValueError(f"malformed result row: {line[:80]!r}")
                rows[m.group(1)] = (np.array([float(v) for v in m.group(2).split(",")]), int(m.group(3)))
        return rows

    def readings(self, sample: int) -> Dict:
        """The program's rows: how many never came, and a sample drawn from
        the seed, with the clips they answer."""
        rows = self.rows()
        expected = self.window_batches * self.B
        ids = sorted(rows, key=lambda k: tuple(int(x) for x in k.split("_")))
        rng = np.random.default_rng(self.seed)
        pick = [ids[j] for j in rng.choice(len(ids), size=min(sample, len(ids)), replace=False)] if ids else []
        clips = [self.host[int(k.split("_")[0]) % self.P][int(k.split("_")[1])] for k in pick]
        return {"missing": expected - len(rows), "ids": pick, "rows": [rows[k] for k in pick],
                "clips": torch.from_numpy(np.stack(clips)) if clips else None}

    def reference(self, clips: torch.Tensor, quant: Optional[str] = None) -> Dict:
        """The reference's outputs on `clips` (`run_eval`), from the seed's
        weights."""
        weights = make_weights(model_shapes(self.cfg), self.seed, self.device)
        return ref_train.run_eval(self.cfg, weights, clips, self.device, REF_ROWS, quant)

    def check(self, limits: dict) -> Dict:
        prog = self.readings(self.traffic.get("check_rows", 36))
        with reference_precision():
            ref = self.reference(prog["clips"]) if prog["clips"] is not None else None
        return judge(eval_gaps(prog, ref), limits)

    def close(self) -> None:
        shutil.rmtree(self.out_dir, ignore_errors=True)


def reference_rows(out: Dict, fault: Optional[str] = None) -> List[tuple]:
    """The rows a run of the reference in the program's place would write:
    per clip, its selected slot's scene logits and its teacher's argmax.
    A planted fault: `wrong_slot` writes the logits of the slot with the
    lowest criterion; `label_altered` the class after the teacher's argmax."""
    rows = []
    for k in range(out["crit"].shape[0]):
        crit = out["crit"][k]
        slot = int(crit.argmin() if fault == "wrong_slot" else crit.argmax())
        label = int(out["teacher"][k].argmax())
        if fault == "label_altered":
            label = (label + 1) % out["teacher"].shape[-1]
        rows.append((out["slot_logits"][k][slot].numpy(), label))
    return rows


def eval_gaps(prog: Dict, ref: Optional[Dict]) -> Dict[str, float]:
    """The eval cell's compared numbers. missing: rows due in the window
    that the file lacks. Per sampled row, the slot whose reference logits
    lie nearest the row; logit_gap: the largest difference from them
    against their largest magnitude; select_gap: how far that slot's
    selection criterion (its highest scene probability) lies below the
    best slot's, so a row may hold another slot than the reference selects
    only where the two are near a tie; label_gap: how far the reference
    teacher's logit of the row's label lies below its best, in standard
    deviations of the row, so a label may differ from the reference's only
    near a tie."""
    out = {"missing": float(prog["missing"])}
    if ref is None:
        return {**out, "logit_gap": math.inf, "select_gap": math.inf, "label_gap": math.inf}
    logit_gap = select_gap = label_gap = 0.0
    for k, (logits, label) in enumerate(prog["rows"]):
        row = torch.from_numpy(logits).float()
        slots = ref["slot_logits"][k]
        gaps = [float((row - s).abs().max() / s.abs().max()) for s in slots]
        s_k = int(np.argmin(gaps))
        logit_gap = max(logit_gap, gaps[s_k])
        crit = ref["crit"][k]
        select_gap = max(select_gap, float(crit.max() - crit[s_k]))
        t = ref["teacher"][k]
        label_gap = max(label_gap, float((t.max() - t[label]) / t.std()))
    return {**out, "logit_gap": logit_gap, "select_gap": select_gap, "label_gap": label_gap}


@contextlib.contextmanager
def reference_precision():
    """Full float32 products while the reference runs (TF32 off)."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved

