"""The serving slice end to end against the JAX package: the same seeded
embedder checkpoint and shipped aggregator, the same uint8 bag, through the
JAX InferenceService (with every InstanceNorm routed through the Pallas
kernel, ResNetConfig.fused_in=True, in interpret mode) and through the
port's service built by its CLI (tpumil_torch.cli.serve.build_service).
"""

import dataclasses
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpumil.infer.service import InferenceService as JaxService
from tpumil.io import torch_ckpt as jckpt
from tpumil.models import embedder as jemb
from tpumil_torch.cli import serve

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")
PATCH = 64     # at 32^2 the instance-normed last stage is 1x1 (all zeros)
BATCH = 8
# features agree to 1e-4 after ~20 normalizations (test_in_pallas.py:54);
# instance logits, attention and scores are smooth functions of them
TOL = dict(rtol=1e-4, atol=1e-4)


class _FusedEmbCfg:
    """EmbedderConfig proxy that sets ResNetConfig.fused_in=True."""

    def __init__(self, base):
        self._base = base

    def __getattr__(self, name):
        return getattr(self._base, name)

    @property
    def resnet_cfg(self):
        return dataclasses.replace(self._base.resnet_cfg, fused_in=True)


@pytest.fixture(scope="module")
def services(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("slice")
    cfg_j = jemb.EmbedderConfig(backbone="resnet18", norm="instance",
                                num_classes=2, compute_dtype=jnp.float32,
                                precision="highest")
    params = jemb.init_params(jax.random.PRNGKey(0), cfg_j)
    ckpt = str(tmp / "embedder.pth")
    jckpt.save_state_dict(jemb.export_embedder_state_dict(params, cfg_j), ckpt)
    agg_path = os.path.join(DATA, "tcga_aggregator.pth")
    agg_params, _ = jckpt.load_aggregator_pth(agg_path)
    params = jemb.set_head(params, agg_params["i_fc"]["w"],
                           agg_params["i_fc"]["b"])
    jax_svc = JaxService(params, _FusedEmbCfg(cfg_j), agg_params=agg_params,
                         batch_size=BATCH, patch_size=PATCH, max_wait_ms=5.0)
    args = serve.parse_args([
        "--embedder_weights", ckpt, "--aggregator_weights", agg_path,
        "--num_classes", "2", "--device", "cpu", "--precision", "f32",
        "--batch_size", str(BATCH), "--patch_size", str(PATCH),
        "--max_wait_ms", "5"])
    port_svc = serve.build_service(args)
    yield jax_svc, port_svc
    jax_svc.close()
    port_svc.close()


@pytest.mark.parametrize("n", [5, 19])
def test_predict_patches_matches_jax(services, n):
    jax_svc, port_svc = services
    bag = np.random.default_rng(n).integers(0, 256, (n, PATCH, PATCH, 3),
                                            np.uint8)
    want = jax_svc.predict_patches(bag)
    got = port_svc.predict_patches(bag)
    assert np.abs(want["ins_logits"]).max() > 1e-3  # a real comparison
    np.testing.assert_allclose(got["ins_logits"], want["ins_logits"], **TOL)
    np.testing.assert_allclose(got["attention"], want["attention"], **TOL)
    np.testing.assert_allclose(got["scores"], want["scores"], **TOL)
    assert got["attention"].shape == (n, 2)
    np.testing.assert_allclose(port_svc.embed(bag), jax_svc.embed(bag), **TOL)


def test_predict_on_features_matches_jax(services):
    jax_svc, port_svc = services
    feats = np.random.default_rng(3).standard_normal((37, 512)) \
        .astype(np.float32)
    want, got = jax_svc.predict(feats), port_svc.predict(feats)
    for key in ("scores", "attention", "ins_logits"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-5)
    assert got["detected"] == want["detected"]


_PORT_MODULES = [
    "tpumil_torch", "tpumil_torch.cli.serve", "tpumil_torch.cli.attention_map",
    "tpumil_torch.infer.service", "tpumil_torch.infer.client",
    "tpumil_torch.infer.heatmap", "tpumil_torch.infer.common",
    "tpumil_torch.io.torch_ckpt", "tpumil_torch.io.from_jax",
    "tpumil_torch.models.embedder", "tpumil_torch.models.resnet",
    "tpumil_torch.models.dsmil", "tpumil_torch.models.registry",
    "tpumil_torch.ops.instance_norm", "tpumil_torch.ops.masked",
    "tpumil_torch.ops.image", "tpumil_torch.utils.build",
    "tpumil_torch.utils.device", "tpumil_torch.ops.attention_pool",
    "tpumil_torch.ops.losses", "tpumil_torch.ops.init",
    "tpumil_torch.data.bags", "tpumil_torch.data.feature_store",
    "tpumil_torch.data.device_store", "tpumil_torch.train.metrics",
    "tpumil_torch.train.optim", "tpumil_torch.train.trainer",
    "tpumil_torch.train.schemes", "tpumil_torch.io.native_ckpt",
    "tpumil_torch.cli.train_wsi", "tpumil_torch.ops.stem",
    "tpumil_torch.utils.sharding", "tpumil_torch.utils.native",
    "tpumil_torch.data.patches", "tpumil_torch.infer.features",
    "tpumil_torch.cli.compute_feats", "chip_smoke", "tools.serve_profile",
    "tools.train_profile", "tools.extract_profile", "tools.in_sweep",
    "tools.k3_accuracy", "tools.stem_profile", "tpumil_torch.data.slide",
    "tpumil_torch.data.tiler", "tpumil_torch.cli.tiler",
    "tpumil_torch.cli.crop_single", "tpumil_torch.infer.stream_embed",
    "tpumil_torch.cli.slide_feats", "tools.stream_profile",
    "tpumil_torch.cli.train_mil", "tpumil_torch.data.mil_bench",
    "tpumil_torch.models.abmil", "tpumil_torch.models.poolmil",
    "tpumil_torch.models.milnet", "tools.mil_profile",
    "tpumil_torch.cli.testing_tcga", "tpumil_torch.cli.testing_c16",
    "tools.heatmap_profile", "tpumil_torch.ops.nt_xent",
    "tpumil_torch.ops.augment", "tpumil_torch.models.simclr",
    "tpumil_torch.models.baseline_encoder", "tpumil_torch.utils.prof",
    "tpumil_torch.train.simclr_trainer", "tpumil_torch.cli.simclr_train",
    "tpumil_torch.io.config", "tpumil_torch.cli.pipeline",
    "tpumil_torch.cli.download", "tpumil_torch.cli.__main__",
    "tpumil_torch.parallel.mesh", "tpumil_torch.parallel.bag_shard",
    "tpumil_torch.parallel.sharded_train",
]
# not installed beside the card (sklearn, optax, orbax, pandas), or the
# package the port replaces
_BANNED = ("jax", "jaxlib", "tpumil", "sklearn", "optax", "orbax", "pandas")


def test_port_imports_neither_jax_nor_tpumil():
    code = ("import importlib, sys\n"
            f"for m in {_PORT_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            f"             if m.split('.')[0] in {_BANNED!r})\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_port_sources_have_no_jax_or_tpumil_import():
    pat = re.compile(rf"^\s*(import|from)\s+({'|'.join(_BANNED)})(\.|\s|$)",
                     re.M)
    files = [os.path.join(d, f)
             for d, _, fs in os.walk(os.path.join(REPO, "tpumil_torch"))
             for f in fs if f.endswith(".py")]
    files.append(os.path.join(REPO, "chip_smoke.py"))
    files += [os.path.join(REPO, "tools", f)
              for f in os.listdir(os.path.join(REPO, "tools"))
              if f.endswith(".py")]
    assert len(files) > 25
    for path in files:
        with open(path) as f:
            assert not pat.search(f.read()), path


def test_chip_smoke_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
