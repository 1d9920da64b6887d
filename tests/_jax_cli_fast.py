"""The JAX CLI's eval commands run cheaper in the port's tests, with the
same numbers.

- `Trainer.init_state` builds its parameter template from `jax.eval_shape`:
  every caller here restores a checkpoint over it, which overwrites every
  leaf (the eager flax init of a DeepFNet costs ~30 s on the CPU).
- `val_rt_batch` runs under `jax.jit` (the CLI calls it eagerly, a compile
  for every operation).
"""

import jax
import jax.numpy as jnp

from deepfepe_tpu import eval as j_eval
from deepfepe_tpu.train import loop as j_loop

STATIC = ("ransac_hypotheses", "ransac_threshold_px", "five_point")


def template_init_state(self, example_batch):
    batch = j_loop.shard_batch(self.mesh, example_batch)
    rngs = {"params": jax.random.PRNGKey(self.rng_seed),
            "sample": jax.random.PRNGKey(self.rng_seed + 1)}
    shapes = jax.eval_shape(self.net.init, rngs, batch)
    params = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)
    self.state = j_loop.shard_params(self.mesh, j_loop.TrainState.create(params, self.tx))
    return self.state


def jitted_val_rt():
    return jax.jit(j_eval.val_rt_batch, static_argnames=STATIC)


def patch_jax_cli(mp, val_rt=None):
    """Install both on a MonkeyPatch; `val_rt` replaces the jitted
    val_rt_batch (a wrapper that records, say)."""
    mp.setattr(j_loop.Trainer, "init_state", template_init_state)
    mp.setattr(j_eval, "val_rt_batch", val_rt or jitted_val_rt())
