"""Shared helpers of the SimCLR parity tests: the unit uniforms that the JAX
package's ``augment_one`` draws from a per-image key, in the port's layout
(tpumil_torch/ops/augment.py), so both packages augment with the same draws.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tpumil_torch.ops import augment as ta


def _uniforms_of(key):
    """The draws of tpumil/ops/augment.py::augment_one (keys split as
    :160-171, rrc_params :37-53, _color_jitter :92; a bernoulli coin is
    ``uniform < p``), unscaled, in the port's order."""
    ks = jax.random.split(key, 7)
    k1, k2, k3, k4 = jax.random.split(ks[0], 4)
    kb, kc, kss, kh = jax.random.split(ks[3], 4)
    one = [jax.random.uniform(k)[None]
           for k in (k3, k4, ks[1], ks[2], kb, kc, kss, kh, ks[4], ks[5],
                     ks[6])]
    return jnp.concatenate([jax.random.uniform(k1, (ta.ATTEMPTS,)),
                            jax.random.uniform(k2, (ta.ATTEMPTS,))] + one)


_batched = jax.jit(jax.vmap(_uniforms_of))
# the layout above, checked against the port's indices
assert (ta.X0, ta.Y0, ta.FLIP, ta.JITTER, ta.FACTORS.start, ta.GRAY,
        ta.BLUR, ta.SIGMA, ta.N_UNIFORMS) == (20, 21, 22, 23, 24, 28, 29, 30,
                                              31)


def jax_uniforms(keys) -> torch.Tensor:
    """[B, N_UNIFORMS] f32 from B per-image keys."""
    return torch.from_numpy(np.array(_batched(keys)))


def pair_uniforms(keys1, keys2) -> torch.Tensor:
    """[2, B, N_UNIFORMS] from the per-image keys of ``pair_keys``."""
    return torch.stack([jax_uniforms(keys1), jax_uniforms(keys2)])
