"""Faults planted underneath the timed path, to show that the check that
decides ``correct`` catches them. Each fault patches the program in this
process and returns a function that takes the patch out again.

  * ``state_unchanged``: every optimizer step returns the state as it was
    (``torch.optim.Adam.step`` does nothing);
  * ``half_batch``: the DSMIL forward sees the first half of each bag, and
    its pooling is the mean over those instances; the SimCLR step encodes
    the first half of each batch of views twice over;
  * ``answer_altered``: every feature the embedder produces has its last
    value raised by 0.01.

The cells that can have each fault: training cells the first two, the
cells that return features the last.
"""

from __future__ import annotations

from typing import Callable, Dict

FAULTS = ("state_unchanged", "half_batch", "answer_altered")


def _patch(obj, name: str, new) -> Callable[[], None]:
    old = getattr(obj, name)
    setattr(obj, name, new)
    return lambda: setattr(obj, name, old)


def state_unchanged() -> Callable[[], None]:
    import torch

    return _patch(torch.optim.Adam, "step", lambda self, closure=None: None)


def half_batch() -> Callable[[], None]:
    from tpumil_torch.models import dsmil
    from tpumil_torch.train import simclr_trainer

    fwd = dsmil.DSMIL.forward

    def dsmil_half(self, feats, *args, **kwargs):
        return fwd(self, feats[..., : max(feats.shape[-2] // 2, 1), :],
                   *args, **kwargs)

    encode = simclr_trainer.SimCLRTrainer.encode

    def encode_half(self, model, u, images):
        h = max(images.shape[0] // 2, 1)
        z1, z2 = encode(self, model, u[:, :h], images[:h])
        rep = -(-images.shape[0] // h)
        return (z1.repeat(rep, 1)[: images.shape[0]],
                z2.repeat(rep, 1)[: images.shape[0]])

    undo = [_patch(dsmil.DSMIL, "forward", dsmil_half),
            _patch(simclr_trainer.SimCLRTrainer, "encode", encode_half)]
    return lambda: [u() for u in undo]


def answer_altered() -> Callable[[], None]:
    from tpumil_torch.models import embedder

    fwd = embedder.Embedder.forward

    def altered(self, x):
        feats, logits = fwd(self, x)
        feats = feats.clone()
        feats[:, -1] += 0.01
        return feats, logits

    return _patch(embedder.Embedder, "forward", altered)


PLANT: Dict[str, Callable[[], Callable[[], None]]] = {
    "state_unchanged": state_unchanged, "half_batch": half_batch,
    "answer_altered": answer_altered}
