"""Train and eval steps (port of ``tdspa/train/step.py``).

A step computes the loss of a batch, its gradients by autograd and one
optimizer update; metrics are returned as device scalars under JAX's names
(``train/{loss,position_loss,visible_loss,learning_rate}``,
``eval/{loss,position_loss,visible_loss}``), so reading them is the only
synchronisation.

With a ``mesh`` (``tdspa_torch.parallel``) each rank runs the step on its
slice of the global batch (``shard_batch``: batch over ``data``, the support
tracks and queries over ``seq``) with replicated parameters
(``parallel.mesh.replicate``). The loss's denominator is the whole batch's
visible mass (summed over the ranks before the division), each rank's
readout tokens are gathered over ``seq`` before the latents, and each rank
decodes its own queries with its rows of the whole batch's dither. The
gradients and the loss terms are then summed over every rank, so every rank
applies the update of the global batch's loss, the single-device step's.
Eager PyTorch traces nothing, so there is no retrace to guard against; a
sharded step creates no process group.
"""

from __future__ import annotations

import torch
from torch.func import functional_call

from tdspa_torch.models import TrackAutoEncoder3D
from tdspa_torch.parallel.mesh import mesh_sum
from tdspa_torch.parallel.shardings import model_kwargs
from tdspa_torch.train.losses import compute_loss_2d, compute_loss_3d

LOSS_KEYS = ("total_loss", "position_loss", "visible_loss")


def _loss_fn(model):
    return compute_loss_3d if isinstance(model, TrackAutoEncoder3D) else compute_loss_2d


def forward_and_loss(model, batch, mesh=None, visible_mass=None, params=None):
    """(predictions, loss dict) of ``batch``. With a ``mesh`` the batch is
    this rank's shard: the predictions are its queries', and each loss term
    is its share, over ``visible_mass`` (default: the whole batch's, summed
    over the mesh). ``params`` replaces the model's own parameters."""
    kwargs = {}
    if mesh is not None:
        if visible_mass is None:
            (visible_mass,) = mesh_sum([batch["query_tracks_visible"].float().sum()], mesh)
        kwargs = model_kwargs(mesh, model, batch)
    predictions = (model(batch, **kwargs) if params is None
                   else functional_call(model, params, (batch,), kwargs))
    return predictions, _loss_fn(model)(predictions, batch, visible_mass=visible_mass)


def loss_and_grads(model, params: dict[str, torch.Tensor], batch, mesh=None,
                   visible_mass=None) -> tuple[dict, list]:
    """(loss dict, gradients of the total loss w.r.t. ``params`` in their
    order); ``params`` must be ``model``'s own parameters. With a ``mesh``,
    this rank's shares (``forward_and_loss``), not yet summed over the mesh."""
    _, loss_dict = forward_and_loss(model, batch, mesh, visible_mass)
    grads = torch.autograd.grad(loss_dict["total_loss"], list(params.values()))
    return loss_dict, list(grads)


def _global(losses: dict, mesh) -> dict:
    """Each loss term summed over the mesh's ranks."""
    return dict(zip(LOSS_KEYS, mesh_sum([losses[k] for k in LOSS_KEYS], mesh)))


def _apply(state, optimizer, schedule, grads, losses):
    opt_state = optimizer.update(grads, state.opt_state, state.params)
    lr = schedule(state.step) if schedule is not None else 0.0
    metrics = {
        "train/loss": losses["total_loss"].detach(),
        "train/position_loss": losses["position_loss"].detach(),
        "train/visible_loss": losses["visible_loss"].detach(),
        "train/learning_rate": lr,
    }
    return state.replace(opt_state=opt_state, step=state.step + 1), metrics


def make_train_step(model, optimizer, schedule=None, mesh=None):
    """step(state, batch) -> (new_state, metrics): one update of ``model``'s
    parameters (``state.params``, updated in place); with a ``mesh``, on this
    rank's shard of the batch (module docstring)."""

    def step(state, batch):
        losses, grads = loss_and_grads(model, state.params, batch, mesh)
        if mesh is not None:
            grads, losses = mesh_sum(grads, mesh), _global(losses, mesh)
        return _apply(state, optimizer, schedule, grads, losses)

    return step


def make_grad_accum_step(model, optimizer, schedule=None, num_microbatches: int = 8, mesh=None):
    """Training step with gradient accumulation over the batch axis.

    The batch is split into ``num_microbatches`` consecutive microbatches;
    each one's gradients are weighted by its clamped visible mass
    ``max(mass, 1)`` (which restores the raw numerator of its loss, the
    all-occluded microbatch's BCE term included) and the sum is divided by
    ``max(true total mass, 1)``: the full batch's gradient, so one update
    equals the full-batch step's. Peak activation memory is one
    microbatch's. With a ``mesh`` the batch is this rank's shard in
    ``shard_batch(..., num_microbatches=...)``'s layout: local microbatch i
    is the rank's slice of global microbatch i, whose mass is summed over
    the mesh; the microbatch axis itself is not sharded.
    """
    m = num_microbatches

    def step(state, batch):
        b = next(iter(batch.values())).shape[0]
        if b % m != 0 or b < m:
            raise ValueError(
                f"batch size {b} must be a positive multiple of "
                f"num_microbatches={m} for gradient accumulation"
            )
        size = b // m
        grads_acc = None
        loss = pos = vis = den_total = 0.0
        for i in range(m):
            mb = {k: v[i * size : (i + 1) * size] for k, v in batch.items()}
            mass = mb["query_tracks_visible"].float().sum()
            if mesh is not None:
                (mass,) = mesh_sum([mass], mesh)
            ld, grads = loss_and_grads(model, state.params, mb, mesh, mass)
            den = torch.clamp(mass, min=1.0)
            weighted = torch._foreach_mul(grads, den)
            if grads_acc is None:
                grads_acc = weighted
            else:
                torch._foreach_add_(grads_acc, weighted)
            del grads, weighted
            loss = loss + den * ld["total_loss"].detach()
            pos = pos + den * ld["position_loss"].detach()
            vis = vis + den * ld["visible_loss"].detach()
            den_total = den_total + mass
        if mesh is not None:
            grads_acc = mesh_sum(grads_acc, mesh)
            loss, pos, vis = mesh_sum([loss, pos, vis], mesh)
        den_total = torch.clamp(den_total, min=1.0)
        torch._foreach_div_(grads_acc, den_total)
        losses = {"total_loss": loss / den_total, "position_loss": pos / den_total,
                  "visible_loss": vis / den_total}
        return _apply(state, optimizer, schedule, grads_acc, losses)

    return step


def make_eval_step(model, mesh=None):
    """step(params, batch) -> (metrics, predictions), without gradients;
    ``params`` is a ``state_dict``-keyed dict (a ``TrainState``'s). With a
    ``mesh`` the metrics are the whole batch's and the predictions this
    rank's shard's (its batch rows and queries)."""

    @torch.no_grad()
    def step(params, batch):
        predictions, loss_dict = forward_and_loss(model, batch, mesh, params=params)
        if mesh is not None:
            loss_dict = _global(loss_dict, mesh)
        metrics = {
            "eval/loss": loss_dict["total_loss"],
            "eval/position_loss": loss_dict["position_loss"],
            "eval/visible_loss": loss_dict["visible_loss"],
        }
        return metrics, predictions

    return step
