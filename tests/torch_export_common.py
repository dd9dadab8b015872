"""Seeded flax-layout weights shared by the port's export and tools tests
(not a test module): numpy arrays the JAX package's export takes as they
are and ``convert`` carries into the port — no JAX mesh, no ``Trainer``."""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np

from tensorflowonspark_tpu.models import factory as jax_factory


def seeded(shapes, seed):
    """Numpy leaves of the flax tree ``shapes`` drawn from ``seed``:
    embeddings N(0, 0.02), kernels N(0, 1/fan_in), layer-norm scales
    1 + N(0, 0.1), biases N(0, 0.1)."""
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        name = str(path[-1].key)
        z = rng.standard_normal(s.shape)
        if name in ("embedding", "pos_embed"):
            z = 0.02 * z
        elif name == "kernel":
            z = z / np.sqrt(s.shape[0])
        elif name == "scale":
            z = 1.0 + 0.1 * z
        else:
            z = 0.1 * z
        return z.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def flax_params(name, kw, example, seed=0):
    """Seeded params of the JAX registry model ``name`` (shapes from
    ``jax.eval_shape`` of its init on ``example``)."""
    model = jax_factory.get_model(name, **kw)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.asarray(example))
    return seeded(nn.meta.unbox(shapes["params"]), seed)
