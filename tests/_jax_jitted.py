"""The JAX reference's set-up passes under ``jax.jit``, for the port's tests.

Eagerly the reference runs op by op, compiling each op for each new shape: a
calibration pass (``repro.core.calibration.Observer`` is host-side) takes 10-20
s for a smoke model, a ``quantize_tree`` several seconds. Under ``jax.jit`` each
is one compiled call. Their values are the jitted reference's (ROADMAP C: the
port is held against the reference's jitted form), which differ from the eager
ones by ulps, so a test that holds the port's offline ``quantize_tree`` (the
eager reference's true division) leaf by leaf keeps the eager form; a tree both
engines serve may come from either.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np

from repro.core import calibration as jcal
from repro.models import model as JM
from repro.models import quantize as JMQ
from repro.models.layers import QuantContext as JQuantContext


@functools.lru_cache(maxsize=None)
def _jit_quantize():
    return jax.jit(JMQ.quantize_tree, static_argnums=1)


def quantize_tree(params, quant, tables=None):
    """``repro.models.quantize.quantize_tree(params, quant, tables=tables)`` under
    ``jax.jit``."""
    return _jit_quantize()(params, quant, tables=tables)


class _TracedObserver:
    """``repro.core.calibration.Observer``'s hard max (``momentum=None``) over
    traced values: each name's column absmax, the max of its observations."""

    def __init__(self):
        self.col_max = {}

    def observe(self, name, x):
        flat = jnp.abs(x).reshape(-1, x.shape[-1]).max(axis=0).astype(jnp.float32)
        self.col_max[name] = (flat if name not in self.col_max
                              else jnp.maximum(self.col_max[name], flat))


def observer_tables(params, batch, cfg, quant, **apply_kw):
    """The ``Observer.tables()`` of one calibration pass of ``JM.apply`` (with
    ``apply_kw``, e.g. ``mode="train", unroll=True``) under ``jax.jit``, as numpy;
    ``jcal.stack_tables`` of them keys them by parameter path."""
    def run(p, b):
        obs = _TracedObserver()
        JM.apply(p, b, cfg, ctx=JQuantContext(quant, observer=obs), **apply_kw)
        return obs.col_max

    return {k: np.asarray(v) for k, v in jax.jit(run)(params, batch).items()}


def stacked_tables(params, batch, cfg, quant, **apply_kw):
    """:func:`observer_tables` keyed by parameter path (``jcal.stack_tables``)."""
    return jcal.stack_tables(observer_tables(params, batch, cfg, quant, **apply_kw))
