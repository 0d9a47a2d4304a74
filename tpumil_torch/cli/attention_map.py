"""Model assembly of the inference scripts (counterpart of
tpumil/cli/attention_map.py::load_milnet; the heatmap CLI itself comes with
the inference slice)."""

from __future__ import annotations

import torch


def load_milnet(embedder_weights: str, aggregator_weights: str,
                num_classes: int, device: torch.device, norm: str = "instance",
                backbone: str = "resnet18", precision: str = "f32",
                space_to_depth: bool = False):
    """Embedder by the positional surgery, aggregator from a ``.pth`` of any
    registry schema, instance head overwritten from the aggregator's
    ``i_classifier.fc.0.*`` (DSMIL) or ``i_classifier.fc.*`` (the others),
    as the reference's attention_map.py does.

    ``precision`` defaults to f32: the shipped reference thresholds were
    derived from f32 torch inference. ``embedder_weights="ImageNet"`` gives
    a seeded random-init embedder (no weights are downloaded).

    Returns (embedder, emb_cfg, aggregator, model_name)."""
    from tpumil_torch.io import torch_ckpt
    from tpumil_torch.models import embedder
    from tpumil_torch.models.embedder import EmbedderConfig

    agg, agg_cfg, model_name = torch_ckpt.load_mil_pth(aggregator_weights,
                                                       device)
    if agg_cfg.num_classes != num_classes:
        raise ValueError(
            f"aggregator has {agg_cfg.num_classes} classes, expected "
            f"{num_classes} (check --num_classes / the checkpoint)")
    emb_cfg = EmbedderConfig(backbone=backbone, norm=norm,
                             num_classes=agg_cfg.num_classes,
                             precision=precision, space_to_depth=space_to_depth)
    if embedder_weights == "ImageNet":
        print("ImageNet embedder requested; supply a local .pth for real "
              "features. Using a seeded random init.")
        emb = embedder.init_params(0, emb_cfg, device)
    else:
        emb = embedder.load_simclr_checkpoint(embedder_weights, emb_cfg, device)
    fc = agg.i_classifier.fc
    if isinstance(fc, torch.nn.Sequential):
        fc = fc[0]
    emb.set_head(fc.weight.detach(), fc.bias.detach())
    return emb, emb_cfg, agg, model_name
