"""One rank of the port's data-parallel multi-task step, the program of
`tests/test_torch_multi_task.py::test_data_parallel_step_matches_jax_whole_batch`
(a helper module, not a test; it imports no JAX):

    python tests/_mt_dp_rank.py RANK DIR

It reads DIR/ref.pt (the weights and batches the test wrote), joins the
gloo group of DEVIAS_TPU_COORDINATOR / NUM_PROCS / PROC_ID
(`tests/_torch_parallel.py::run_ranks` starts it),
runs the step with `dp_mesh=make_mesh()` on its rows of every micro-batch
and writes DIR/rank{RANK}.pt: (metrics per step, final parameters, summed
lr)."""

import sys
from pathlib import Path

import numpy as np
import torch

WORLD = 2
U, B, STEPS = 2, 8, 2  # global batch 8 = update_freq 2 x micro-batch 4 = 2 ranks of 2
A, S = 5, 4
SMALL = dict(depth=2, embed_dim=64, num_heads=4)
DP_OPT = dict(lr=1e-3, min_lr=1e-5, warmup_lr=1e-4, total_steps=8, warmup_steps=1, layer_decay=0.75,
              weight_decay=0.05, weight_decay_end=0.1, num_layers=2)


def _load(model, sd):
    model.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()})
    return model


def main(rank: int, out: Path) -> None:
    import torch.distributed as dist

    from devias_tpu_torch.core.dist import make_mesh, maybe_init_distributed
    from devias_tpu_torch.losses import cross_entropy
    from devias_tpu_torch.nn import create_model
    from devias_tpu_torch.train import OptimConfig, TrainState, make_multi_task_train_step, make_optimizer

    assert maybe_init_distributed("cpu") and dist.get_backend() == "gloo"
    ref = torch.load(out / "ref.pt", weights_only=False)
    model = _load(create_model("disentangle_vit_base_patch16_224", device="cpu", num_classes=A, num_scene_classes=S,
                               unified_head=True, img_size=32, num_frames=4, **SMALL), ref["init"])
    teacher = _load(create_model("vit_base_patch16_224", device="cpu", num_classes=S, use_mean_pooling=False,
                                 **SMALL), ref["teacher"])
    opt, lr_fn = make_optimizer(model, OptimConfig(**DP_OPT), device="cpu")
    state = TrainState.create(model, opt, device="cpu")
    step = make_multi_task_train_step(model, teacher, opt, A, "KL", 1.0, True, cross_entropy, U, lr_fn,
                                      dp_mesh=make_mesh(), device="cpu")
    # rank r holds the r-th half of each micro-batch
    mb, local = B // U, B // U // WORLD
    rows = np.concatenate([np.arange(u * mb + rank * local, u * mb + (rank + 1) * local) for u in range(U)])
    metrics = [step(state, {k: v[rows] for k, v in batch.items()}, generator=torch.Generator().manual_seed(1),
                    host_metrics=True) for batch in ref["batches"]]
    final = {n: p.detach().clone() for n, p in model.named_parameters()}
    torch.save((metrics, final, sum(lr_fn(s) for s in range(STEPS))), out / f"rank{rank}.pt")
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), Path(sys.argv[2]))
