"""Training loop (port of ``tdspa/train/loop.py``): epochs, periodic eval,
checkpoint save and resume, ``max_steps``, data parallelism over a mesh.

Under an initialised ``torch.distributed`` process group (``torchrun``) each
rank runs this loop on its shard of every global batch; rank 0 alone logs
and writes checkpoints, and every rank reads the checkpoint it resumes from.
"""

from __future__ import annotations

import logging
import math

import numpy as np
import torch
import torch.distributed as dist

from tdspa_torch.data.prefetch import device_prefetch, to_device
from tdspa_torch.infer.checkpoint import TrainCheckpointer
from tdspa_torch.parallel.mesh import make_mesh, replicate
from tdspa_torch.parallel.shardings import shard_batch
from tdspa_torch.train.metrics import MetricLogger
from tdspa_torch.train.state import OptState, create_model_state
from tdspa_torch.train.step import make_eval_step, make_grad_accum_step, make_train_step
from tdspa_torch.utils.device import resolve_device

log = logging.getLogger(__name__)


def state_tree(state) -> dict:
    """A ``TrainState`` as the tree ``TrainCheckpointer`` saves (host copies)."""
    def host(tensors):
        return {k: v.detach().cpu() for k, v in tensors.items()}

    return {
        "params": host(state.params),
        "opt_state": {"count": state.opt_state.count, "mu": host(state.opt_state.mu),
                      "nu": host(state.opt_state.nu)},
        "step": state.step,
    }


def restore_state(state, tree):
    """``state`` with the parameters (copied in place) and optimizer state of
    a saved tree."""
    with torch.no_grad():
        for name, param in state.params.items():
            param.copy_(tree["params"][name])
    device = next(iter(state.params.values())).device
    opt = tree["opt_state"]
    return state.replace(
        opt_state=OptState(count=int(opt["count"]),
                           mu={k: v.to(device) for k, v in opt["mu"].items()},
                           nu={k: v.to(device) for k, v in opt["nu"].items()}),
        step=int(tree["step"]),
    )


def train(
    train_ds,
    eval_ds=None,
    model_type: str = "3dspa",
    num_epochs: int = 300,
    learning_rate: float = 1e-4,
    warmup_steps: int = 10_000,
    num_output_frames: int = 150,
    use_dino: bool = True,
    use_depth: bool = True,
    eval_freq: int = 1000,
    save_freq: int = 5000,
    log_freq: int = 10,
    checkpoint_dir: str | None = "./checkpoints",
    logger: MetricLogger | None = None,
    mesh=None,
    resume: bool = True,
    seed: int = 42,
    max_steps: int | None = None,
    grad_accum_steps: int = 1,
    device="cuda",
    **model_overrides,
):
    """Run the training loop on ``device`` (GPU unless ``device="cpu"``);
    returns the final ``TrainState``.

    ``train_ds`` / ``eval_ds`` iterate over prepared batches of numpy arrays
    or tensors (e.g. ``tdspa_torch.data.providers.BatchedTrackDataset``);
    ``eval_ds`` needs ``take``. The cadence is JAX's: metrics every
    ``log_freq`` steps, eval on 10 batches every ``eval_freq`` steps, a
    checkpoint every ``save_freq`` steps, resume from the latest one.

    ``mesh`` (``tdspa_torch.parallel.make_mesh``): each rank trains on its
    shard of every batch. Under an initialised process group with no mesh,
    the ``data`` axis takes the largest rank count that divides the batch
    (``gcd(batch, world)``, as JAX sizes it); ranks past it idle and return
    None. The parameters are broadcast from the mesh's first rank once.
    """
    device = resolve_device(device)
    logger = logger or MetricLogger(use_wandb=False)
    # JAX draws a dummy batch to shape its init; the port draws it too, so
    # that a BatchedTrackDataset's epochs shuffle as JAX's do.
    dummy_batch = next(iter(train_ds))
    distributed = dist.is_available() and dist.is_initialized()
    if mesh is None and distributed:
        data = math.gcd(int(np.shape(dummy_batch["support_tracks"])[0]), dist.get_world_size())
        mesh = make_mesh(data=data, seq=1, devices=list(range(data)))
    main = not distributed or dist.get_rank() == 0
    if mesh is not None and dist.get_rank() not in mesh.mesh.flatten().tolist():
        log.info("rank %d is outside the %s mesh; it idles", dist.get_rank(),
                 tuple(mesh.mesh.shape))
        return None
    steps_per_epoch = max(len(train_ds), 1) if hasattr(train_ds, "__len__") else 1000
    state, model, optimizer, schedule = create_model_state(
        seed, model_type=model_type, learning_rate=learning_rate, warmup_steps=warmup_steps,
        total_steps=steps_per_epoch * num_epochs, num_output_frames=num_output_frames,
        use_dino=use_dino, use_depth=use_depth, device=device, **model_overrides,
    )

    ckptr = TrainCheckpointer(checkpoint_dir) if checkpoint_dir else None
    if ckptr is not None and resume and ckptr.latest_step() is not None:
        state = restore_state(state, ckptr.restore())

    if mesh is not None:
        replicate(list(state.params.values()), mesh)

    if grad_accum_steps > 1:
        train_step = make_grad_accum_step(model, optimizer, schedule,
                                          num_microbatches=grad_accum_steps, mesh=mesh)
    else:
        train_step = make_train_step(model, optimizer, schedule, mesh=mesh)
    eval_step = make_eval_step(model, mesh=mesh)

    def shard(batch, num_microbatches=1):
        return batch if mesh is None else shard_batch(mesh, batch,
                                                      num_microbatches=num_microbatches)

    step = state.step
    for _ in range(num_epochs):
        batches = (shard(b, grad_accum_steps) for b in train_ds)
        for batch in device_prefetch(batches, device=device):
            state, metrics = train_step(state, batch)
            step += 1

            if main and step % log_freq == 0:
                logger.log(metrics, step=step)

            if eval_ds is not None and step % eval_freq == 0:
                agg: dict = {}
                for eval_batch in eval_ds.take(10):
                    m, _ = eval_step(state.params, to_device(shard(eval_batch), device))
                    for k, v in m.items():
                        agg.setdefault(k, []).append(float(v))
                if main:
                    logger.log({k: float(np.mean(v)) for k, v in agg.items()}, step=step)

            if main and ckptr is not None and step % save_freq == 0:
                ckptr.save(step, state_tree(state))

            if max_steps is not None and step >= max_steps:
                if main:
                    logger.finish()
                return state
    if main:
        logger.finish()
    return state
