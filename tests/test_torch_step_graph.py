"""What lets a train step be captured as a CUDA graph, checked on the CPU
(the card's tests are in `tests/test_torch_cuda.py`): the optimizer's
per-update scalars read from its device table against the arithmetic on
Python floats it replaced, the table's counter through a state dict,
FAME's constants made once per device against the ones it made per call,
the predicate that keeps CPU runs, layouts and placed states eager, and a
replay's accounting and run-ahead with a stub graph; on a card (marked
`cuda`), a slot step with the Segformer mix captured and replayed against
its eager steps."""

import copy
import math

import numpy as np
import pytest
import torch

from devias_tpu_torch.aug import fame
from devias_tpu_torch.aug.fame import IMAGENET_MEAN, IMAGENET_STD, FAMEConfig, fame_augment
from devias_tpu_torch.kernels import attention
from devias_tpu_torch.losses import SlotLossConfig
from devias_tpu_torch.nn import create_model
from devias_tpu_torch.train import (OptimConfig, ScheduledOptimizer, TrainState, TrainStepConfig, make_optimizer,
                                    make_slot_train_step)
from devias_tpu_torch.train.graph import RUN_AHEAD, StepGraph, graph_safe
from devias_tpu_torch.utils.profiling import count, counter_totals

SMALL = dict(depth=2, embed_dim=64, num_heads=4)
SLOT = dict(num_classes=5, num_scene_classes=4, num_latents=2, agg_depth=2, **SMALL)
TEACHER = dict(num_classes=4, use_mean_pooling=False, **SMALL)
# 2 warm-up updates, then the cosine; 5 updates run past total_steps, where
# the bias corrections still change and the table grows
OPT = dict(lr=1e-3, min_lr=1e-5, warmup_lr=1e-4, total_steps=4, warmup_steps=2, layer_decay=0.75,
           agg_block_scale=0.1, weight_decay_end=0.1, num_layers=2, momentum=0.8)


def _previous_update(opt, cfg, params, grads, buffers, count):
    """One update as the optimizer computed it with Python-float scalars
    (lr, wd, the bias corrections and -(lr * s) passed to the foreach
    kernels as Python numbers). `buffers` holds the state, updated in
    place; returns nothing, updates `params` in place."""
    lr, wd = opt.lr_fn(count), opt.wd_fn(count)
    dec = [i for i, d in enumerate(opt.decay) if d]

    def add_l2(gs):
        gs = list(gs)
        if dec and wd != 0.0:
            for i, g in zip(dec, torch._foreach_add([gs[i] for i in dec], [params[i] for i in dec], alpha=wd)):
                gs[i] = g
        return gs

    if cfg.opt in ("adamw", "adam"):
        l2 = cfg.opt == "adam"
        if l2:
            grads = add_l2(grads)
        ms, vs = buffers["exp_avg"], buffers["exp_avg_sq"]
        b1, b2 = cfg.beta1, cfg.beta2
        c = count + 1
        bc1, bc2 = 1 - b1 ** c, 1 - b2 ** c
        torch._foreach_mul_(ms, b1)
        torch._foreach_add_(ms, grads, alpha=1 - b1)
        torch._foreach_mul_(vs, b2)
        torch._foreach_addcmul_(vs, grads, grads, value=1 - b2)
        denom = torch._foreach_div(vs, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, cfg.eps)
        upd = torch._foreach_div(ms, bc1)
        torch._foreach_div_(upd, denom)
        if not l2 and dec and wd != 0.0:
            torch._foreach_add_([upd[i] for i in dec], [params[i] for i in dec], alpha=wd)
    else:
        grads = add_l2(grads)
        trace = buffers["momentum_buffer"]
        torch._foreach_mul_(trace, cfg.momentum)
        torch._foreach_add_(trace, grads)
        upd = torch._foreach_add(grads, trace, alpha=cfg.momentum)
    torch._foreach_mul_(upd, [-(lr * s) for s in opt.scales])
    torch._foreach_add_(params, upd)


@pytest.mark.parametrize("chunk", [2048, 2], ids=["one_fill", "fills_of_2"])
@pytest.mark.parametrize("weight_decay", [0.0, 0.05], ids=["no_decay", "decay"])
@pytest.mark.parametrize("opt_name", ["adamw", "adam", "sgd"])
def test_device_scalars_equal_the_python_scalar_update(monkeypatch, opt_name, weight_decay, chunk):
    """Five updates through the device table against the previous
    arithmetic, from the same parameters and gradients, across the
    warm-up, the cosine and past total_steps, with the table filled at
    once or two rows at a time: bitwise where the order of
    operations is the same (no weight decay), else within float32
    rounding of the 0.02-sized gradients (wd p is now rounded before its
    sum)."""
    monkeypatch.setattr(ScheduledOptimizer, "TABLE_CHUNK", chunk)
    cfg = OptimConfig(**dict(OPT, opt=opt_name, weight_decay=weight_decay,
                             weight_decay_end=0.1 if weight_decay else 0.0))
    model = create_model("slot_vit_base_patch16_224", device="cpu", img_size=32, **SLOT)
    opt, _ = make_optimizer(model, cfg, device="cpu")
    params = [p.detach().clone() for p in model.parameters()]
    buffers = {name: [torch.zeros_like(p) for p in params] for name in type(opt).BUFFERS}
    versions = {opt.version}
    g = torch.Generator().manual_seed(3)
    for count in range(5):
        grads = [torch.randn(p.shape, generator=g) * 0.02 for p in params]
        for p, gr in zip(model.parameters(), grads):
            p.grad = gr.clone()
        opt.step()
        _previous_update(opt, cfg, params, grads, buffers, count)
        versions.add(opt.version)
        exact = dict(rtol=0, atol=0)
        rounding = exact if weight_decay == 0.0 else dict(rtol=4e-7, atol=1e-8)
        for name, p, want in zip(opt.names, model.parameters(), params):
            torch.testing.assert_close(p.detach(), want, **rounding, msg=f"update {count}: {name}")
        # AdamW's moments never see wd; Adam's and SGD's see g + wd p
        for buf, want in buffers.items():
            for name, got, w in zip(opt.names, opt._buffers(buf), want):
                torch.testing.assert_close(got, w, **(exact if opt_name == "adamw" else rounding),
                                           msg=f"update {count}: {buf} of {name}")
    assert opt.count == 5 and int(opt._counter) == 5
    # the bias corrections change past total_steps (4): the table grew
    assert len(versions) > 1 and opt._table.shape[0] > cfg.total_steps


def test_the_table_holds_the_schedules_values_in_float32():
    cfg = OptimConfig(**dict(OPT, weight_decay=0.05, total_steps=7))
    opt, lr_fn = make_optimizer(create_model("slot_vit_base_patch16_224", device="cpu", img_size=32, **SLOT), cfg,
                                device="cpu")
    table = opt._table.numpy()
    assert table.shape == (7, 3 + len(opt.scale_values))
    for c in range(7):
        assert table[c, 0] == np.float32(opt.wd_fn(c))
        assert table[c, 1] == np.float32(1 - cfg.beta1 ** (c + 1))
        assert table[c, 2] == np.float32(1 - cfg.beta2 ** (c + 1))
        for j, s in enumerate(opt.scale_values):
            assert table[c, 3 + j] == np.float32(-(lr_fn(c) * s))
    assert sorted({i for group in opt.scale_groups for i in group}) == list(range(len(opt.scales)))


def test_the_table_fills_a_chunk_ahead_of_the_count(monkeypatch):
    """A schedule of many steps fills TABLE_CHUNK rows at construction
    and the next chunk when the count reaches them, in place: the
    optimizer's version does not change."""
    monkeypatch.setattr(ScheduledOptimizer, "TABLE_CHUNK", 3)
    cfg = OptimConfig(**dict(OPT, weight_decay=0.05, total_steps=100))
    model = create_model("slot_vit_base_patch16_224", device="cpu", img_size=32, **SLOT)
    opt, _ = make_optimizer(model, cfg, device="cpu")
    table, version = opt._table, opt.version
    assert table.shape[0] == 100 and opt._filled == 3
    for count in range(7):
        for p in model.parameters():
            p.grad = torch.zeros_like(p)
        opt.step()
        assert opt._filled == 3 * (count // 3 + 1)
    assert opt._table is table and opt.version == version
    assert np.array_equal(table[:9].numpy(), opt._rows(0, 9))


@pytest.mark.parametrize("opt_name", ["adamw", "sgd"])
def test_state_dict_round_trips_the_device_counter(opt_name):
    """The count a state dict carries sets the device counter of the
    optimizer it is loaded into, so its next update reads the right row,
    and the load changes the optimizer's version (its state tensors are
    new ones)."""
    cfg = OptimConfig(**dict(OPT, opt=opt_name, weight_decay=0.05))

    def model_and_opt():
        m = create_model("slot_vit_base_patch16_224", device="cpu", img_size=32, **SLOT)
        return m, make_optimizer(m, cfg, device="cpu")[0]

    def set_grads(m, seed):
        g = torch.Generator().manual_seed(seed)
        for p in m.parameters():
            p.grad = torch.randn(p.shape, generator=g) * 0.01

    a, opt_a = model_and_opt()
    for seed in range(3):
        set_grads(a, seed)
        opt_a.step()
    sd = copy.deepcopy(opt_a.state_dict())  # as a checkpoint holds it, apart from opt_a's tensors
    assert sd["count"] == 3 and int(opt_a._counter) == 3
    b, opt_b = model_and_opt()
    b.load_state_dict(a.state_dict())
    version = opt_b.version
    opt_b.load_state_dict(sd)
    assert opt_b.count == 3 and int(opt_b._counter) == 3 and opt_b.version != version
    for m, opt in ((a, opt_a), (b, opt_b)):
        set_grads(m, 9)
        opt.step()
    for (n, p), q in zip(a.named_parameters(), b.parameters()):
        torch.testing.assert_close(p, q, rtol=0, atol=0, msg=n)
    assert int(opt_b._counter) == opt_b.count == 4


def test_fame_constants_are_made_once_and_equal_the_per_call_ones():
    cpu = torch.device("cpu")
    cfg = FAMEConfig()
    for n in (32, 224):
        m = fame._blur_matrix(n, cfg.gauss_size, cfg.gauss_sigma, cpu)
        assert torch.equal(m, torch.from_numpy(fame._blur_band_matrix(n, cfg.gauss_size, cfg.gauss_sigma)))
        assert fame._blur_matrix(n, cfg.gauss_size, cfg.gauss_sigma, cpu) is m
    for values in (IMAGENET_MEAN, IMAGENET_STD, (0.0, 0.0, 0.0)):
        t = fame._channel_constant(values, cpu)
        assert torch.equal(t, torch.tensor(values, dtype=torch.float32)) and t.dtype == torch.float32
        assert fame._channel_constant(list(values), cpu) is t


@pytest.mark.parametrize("downsample", [1, 2])
def test_fame_outputs_are_bitwise_those_of_the_per_call_constants(monkeypatch, downsample):
    """FAME with its cached constants against FAME with the blur matrices,
    the mean and the std made on every call, as before."""
    rng = np.random.default_rng(4)
    videos = torch.from_numpy(rng.normal(size=(3, 4, 32, 48, 3)).astype(np.float32))
    labels = torch.arange(3)
    draws = {"perm": torch.tensor([2, 0, 1]), "keep": torch.tensor([True, False, True])}
    cfg = FAMEConfig(tubelet_mask_downsample=downsample)
    got = fame_augment(videos, labels, cfg, draws=draws)

    def blur_per_call(img, size, sigma):
        _, H, W = img.shape
        Mh = torch.from_numpy(fame._blur_band_matrix(H, size, sigma)).to(img.device)
        Mw = torch.from_numpy(fame._blur_band_matrix(W, size, sigma)).to(img.device)
        return torch.matmul(torch.matmul(Mh, img), Mw.t())

    monkeypatch.setattr(fame, "_gaussian_blur", blur_per_call)
    monkeypatch.setattr(fame, "_channel_constant", lambda v, dev: torch.tensor(v, dtype=torch.float32, device=dev))
    want = fame_augment(videos, labels, cfg, draws=draws)
    for g, w in zip((got[0], got[1], *got[2]), (want[0], want[1], *want[2])):
        assert torch.equal(g, w)


class _Mesh:
    """Stands for a layout: the predicate reads only whether there is one."""


def test_the_graph_engages_only_on_a_card_without_a_layout_or_placement():
    cuda, cpu = torch.device("cuda", 0), torch.device("cpu")
    assert graph_safe(cuda, None, None)
    assert not graph_safe(cpu, None, None)
    assert not graph_safe(cuda, _Mesh(), None)
    assert not graph_safe(cuda, None, object())
    assert not graph_safe(cpu, _Mesh(), object())


def test_a_cpu_step_runs_eager():
    model = create_model("slot_vit_base_patch16_224", device="cpu", img_size=32, **SLOT)
    teacher = create_model("vit_base_patch16_224", device="cpu", **TEACHER)
    opt, lr_fn = make_optimizer(model, OptimConfig(**dict(OPT, weight_decay=0.05)), device="cpu")
    state = TrainState.create(model, opt, device="cpu")
    step = make_slot_train_step(model, teacher, opt, SlotLossConfig(num_action_classes=5, num_scene_classes=4),
                                TrainStepConfig(), lr_fn, device="cpu")
    rng = np.random.default_rng(0)
    batch = {"videos": rng.normal(size=(2, 4, 32, 32, 3)).astype(np.float32), "labels": np.array([1, 3])}
    for _ in range(2):
        m = step(state, batch, generator=torch.Generator().manual_seed(0))
        assert math.isfinite(float(m["loss"]))
    assert isinstance(step.graph, StepGraph)
    assert step.graph.graph is None and step.graph.replays == 0 and not step.graph.failed
    assert state.step == opt.count == int(opt._counter) == 2


class _StubGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


class _StubEvent:
    def __init__(self, log, n):
        self.log, self.n = log, n

    def synchronize(self):
        self.log.append(self.n)


def test_a_replay_adds_the_captured_launches_and_waits_two_back():
    """Each replay adds the K1 launches its capture recorded, counts one
    `train_graph_replays` under a profiler, and before replay n waits for
    the event recorded after replay n - 2."""
    assert RUN_AHEAD == 2
    before = (attention.launch_counts(), attention.launch_counts_by_heads())
    attention.reset_launch_counts()
    attention.KERNELS["K1-fwd"].launches += 1  # a launch of the capture, taken back below
    attention.KERNELS["K1-fwd"].launches_by_heads[12] = 1
    start = (attention.launch_counts(), attention.launch_counts_by_heads())
    attention.KERNELS["K1-fwd-stats"].launches += 12
    attention.KERNELS["K1-fwd-stats"].launches_by_heads[12] = 12
    attention.KERNELS["K1-bwd"].launches += 12
    attention.KERNELS["K1-bwd"].launches_by_heads[12] = 12
    captured = attention.launches_since(*start)
    assert captured[0]["K1-fwd-stats"] == captured[0]["K1-bwd"] == 12 and captured[0]["K1-fwd"] == 0
    attention.set_launch_counts(*start)
    assert attention.launch_counts() == start[0] and attention.launch_counts_by_heads() == start[1]

    sg = StepGraph()
    sg.graph, sg.launches = _StubGraph(), captured
    waited, made = [], []

    def event():
        made.append(_StubEvent(waited, len(made) + 1))
        return made[-1]

    sg._recorded_event = event
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            for n in range(1, 6):
                sg.replay()
                assert len(sg.inflight) <= RUN_AHEAD
                # replay n waited for replay n - 2 alone
                assert waited == list(range(1, n - 1))
        assert counter_totals()["train_graph_replays"] == 5
        assert sg.graph.replays == sg.replays == 5
        counts, heads = attention.launch_counts(), attention.launch_counts_by_heads()
        assert counts["K1-fwd"] == 1 and counts["K1-fwd-stats"] == counts["K1-bwd"] == 60
        assert heads["K1-fwd"] == {12: 1} and heads["K1-fwd-stats"] == heads["K1-bwd"] == {12: 60}
    finally:
        attention.set_launch_counts(*before)


def test_a_replay_adds_the_counts_its_capture_made():
    """The counts made while the step was captured (`mask_frames` on the
    Segformer path) are added after each replay, under a profiler; a
    capture that counted nothing (FAME's) adds nothing but the replay."""
    for counts in ({"mask_frames": 96}, {}):
        sg = StepGraph()
        sg.graph, sg.counts = _StubGraph(), counts
        sg._recorded_event = lambda: _StubEvent([], 0)
        before = (attention.launch_counts(), attention.launch_counts_by_heads())
        count("unprofiled", 0)  # the profiled replays below start the tally anew
        try:
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
                for _ in range(3):
                    sg.replay()
            assert counter_totals() == {"train_graph_replays": 3, **{k: 3 * v for k, v in counts.items()}}
        finally:
            attention.set_launch_counts(*before)


@pytest.mark.cuda
def test_a_segformer_step_replays_its_eager_steps_on_the_card(monkeypatch):
    """The slot step with `segformer_apply` (the port's tiny Segformer in
    bfloat16) on the card: three steps captured and replayed against three
    eager steps (capture forbidden) from the same weights, clips, draws and
    generator, as close as two eager runs are; under a profiler each
    replay counts its B T/2 masked frames (the first step, which captures,
    runs unprofiled), and the mask model's device span, recorded in the
    graph, reads a time after the replays."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import devias_tpu_torch.train.step as step_module
    from devias_tpu_torch.aug import FAMEConfig
    from devias_tpu_torch.nn.segformer import create_segformer
    from devias_tpu_torch.utils import device_span_ms, span

    from _segformer_weights import TINY as TINY_SEGFORMER

    card = torch.device("cuda")
    B = 3

    def run():
        model = create_model("slot_vit_base_patch16_224", device=card, seed=0, img_size=64, num_frames=4,
                             drop_path_rate=0.1, dtype=torch.bfloat16, **SLOT)
        teacher = create_model("vit_base_patch16_224", device=card, seed=1, img_size=64, num_frames=4,
                               dtype=torch.bfloat16, **TEACHER)
        seg = create_segformer(TINY_SEGFORMER, device=card, seed=2, dtype=torch.bfloat16)
        with torch.no_grad():
            seg.decode_head.classifier.bias[11] += 0.05
        opt, lr_fn = make_optimizer(model, OptimConfig(**dict(OPT, weight_decay=0.05)), device=card)
        state = TrainState.create(model, opt, device=card)
        step_cfg = TrainStepConfig(use_fame=False, fame=FAMEConfig(beta=0.5, prob_aug=0.8))
        step = make_slot_train_step(model, teacher, opt, SlotLossConfig(num_action_classes=5, num_scene_classes=4),
                                    step_cfg, lr_fn, segformer_apply=seg, device=card)
        g = torch.Generator(device=card).manual_seed(11)
        data = [({"videos": torch.randn((B, 4, 64, 64, 3), generator=g, device=card),
                  "labels": torch.randint(0, 5, (B,), generator=g, device=card)},
                 {"perm": torch.rand(B, generator=g, device=card).argsort(),
                  "keep": torch.rand(B, generator=g, device=card) < 0.8,
                  "frame": torch.randint(0, 2, (), generator=g, device=card)}) for _ in range(3)]
        gen = torch.Generator(device=card).manual_seed(5)
        # the first step captures, which no profiler may watch; the other
        # two replay under one
        held = [step(state, data[0][0], generator=gen, draws=data[0][1])]
        with span("unprofiled"):
            pass
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            held += [step(state, batch, generator=gen, draws=draws) for batch, draws in data[1:]]
            torch.cuda.synchronize()
        frames = counter_totals().get("mask_frames")
        return ({"metrics": [{k: float(v) for k, v in m.items()} for m in held],
                 "params": [p.detach().float().clone() for p in model.parameters()]},
                step.graph, frames, device_span_ms("train.mask_model"))

    def gap(a, b):
        g = max(abs(x[k] - y[k]) for x, y in zip(a["metrics"], b["metrics"]) for k in x)
        return max(g, max(float((x - y).abs().max()) for x, y in zip(a["params"], b["params"])))

    with monkeypatch.context() as m:
        m.setattr(step_module, "graph_safe", lambda *a: False)
        eager, eager_graph, eager_frames, _ = run()
        again = run()[0]
    graphed, sg, frames, ms = run()
    assert eager_graph.replays == 0 and eager_frames == 2 * B * 2
    # the first call captured, and all three are replays
    assert not sg.failed and sg.replays == 3 and sg.counts == {"mask_frames": B * 2}
    assert frames == 2 * B * 2
    assert ms is not None and ms > 0
    assert gap(graphed, eager) <= gap(again, eager), (gap(graphed, eager), gap(again, eager))
