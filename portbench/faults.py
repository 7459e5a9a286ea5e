"""Faults planted under the timed path, to show that the comparison with
the reference catches them: each wraps the program's step as a drive
loop builds it.  `FAULTS[loop]` maps a fault's name to its wrapper."""
from __future__ import annotations

import torch

__all__ = ["FAULTS"]


def _half_rows(t: torch.Tensor, lead: int) -> torch.Tensor:
    """t with its first `lead` axes flattened to rows, the second half of
    the rows replaced by the first half, and the axes restored: the mean
    over the kept rows, as the step takes it."""
    shape = t.shape
    rows = t.reshape(-1, *shape[lead:])
    keep = rows[: rows.shape[0] // 2]
    return torch.cat([keep, keep]).reshape(shape)


# train: step(model, opt, batch) -> (model, opt, metrics)
def train_unchanged_state(step):
    """The loss is computed, the weights and the optimizer's state are
    returned as they came."""
    from repro_torch import models

    def faulty(model, opt, batch):
        with torch.no_grad():
            losses = [models.loss_fn(model, {k: v[i] for k, v in batch.items()})
                      for i in range(batch["tokens"].shape[0])]
        return model, opt, {"loss": torch.stack(losses).mean()}
    return faulty


def train_half_batch(step):
    def faulty(model, opt, batch):
        return step(model, opt, {k: _half_rows(v, 2) for k, v in batch.items()})
    return faulty


def train_altered_answer(step):
    """The step's loss altered by a relative 1e-3 where it is reported."""
    def faulty(model, opt, batch):
        model, opt, metrics = step(model, opt, batch)
        metrics["loss"] = metrics["loss"] * (1.0 + 1e-3)
        return model, opt, metrics
    return faulty


# prefill: step(model, batch) -> last-position logits [B, V]
def prefill_unchanged_state(step):
    """Every request after the first gets the first one's answer."""
    kept = []

    def faulty(model, batch):
        if not kept:
            kept.append(step(model, batch))
        return kept[0].clone()
    return faulty


def prefill_half_batch(step):
    def faulty(model, batch):
        return step(model, {k: _half_rows(v, 1) for k, v in batch.items()})
    return faulty


def prefill_altered_answer(step):
    """The first prompt's top logit raised by a tenth of its size."""
    def faulty(model, batch):
        out = step(model, batch).clone()
        i = int(out[0].argmax())
        out[0, i] += 0.1 * out[0, i].abs()
        return out
    return faulty


FAULTS = {
    "train": {"unchanged_state": train_unchanged_state,
              "half_batch": train_half_batch,
              "altered_answer": train_altered_answer},
    "prefill": {"unchanged_state": prefill_unchanged_state,
                "half_batch": prefill_half_batch,
                "altered_answer": prefill_altered_answer},
}
