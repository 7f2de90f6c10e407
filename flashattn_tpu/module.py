"""Pytree-native Module system.

JAX re-design of the reference's mutable ``Module``/``Parameter`` tree
(reference ``minitorch/module.py:6-166``).  The reference intercepts
``__setattr__`` to build a named parameter tree and mutates ``.value`` in the
optimizer.  Under ``jax.jit`` mutation is a non-starter, so here a Module *is*
an immutable pytree:

* array-valued attributes (and nested Modules / containers of them) are pytree
  leaves -- ``jax.grad(loss)(model)`` returns a model-shaped gradient pytree;
* everything else (ints, floats, bools, callables) is static metadata hashed
  into the jit cache key;
* "training mode" is not mutable state: forward methods take
  ``training=...`` / ``key=...`` arguments, keeping them pure.

Parity surface kept from the reference: ``named_parameters()``,
``parameters()``, ``train()`` / ``eval()`` (returning *new* modules), and
attribute-style composition of submodules.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

Array = jax.Array


def _is_dynamic(value: Any) -> bool:
    """True if ``value`` participates in the pytree (arrays / Modules / containers of them)."""
    if isinstance(value, (jax.Array, np.ndarray, Module)):
        return True
    if isinstance(value, (list, tuple)):
        return len(value) > 0 and any(_is_dynamic(v) for v in value)
    if isinstance(value, dict):
        return len(value) > 0 and any(_is_dynamic(v) for v in value.values())
    return False


class _Static:
    """Hashable wrapper for static attribute values (by-value for simple types)."""

    __slots__ = ("value",)

    def __init__(self, value: Any):
        self.value = value

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, _Static) and _static_eq(self.value, other.value)

    def __hash__(self) -> int:
        try:
            return hash(_freeze(self.value))
        except TypeError:
            return hash(type(self.value).__name__)


def _freeze(v: Any) -> Any:
    if isinstance(v, (list, tuple)):
        return tuple(_freeze(x) for x in v)
    if isinstance(v, dict):
        return tuple(sorted((k, _freeze(x)) for k, x in v.items()))
    if isinstance(v, set):
        return frozenset(_freeze(x) for x in v)
    return v


def _static_eq(a: Any, b: Any) -> bool:
    try:
        return bool(_freeze(a) == _freeze(b))
    except Exception:
        return a is b


class Module:
    """Base class: an immutable-ish pytree of parameters and submodules.

    Subclasses just assign attributes in ``__init__`` as usual.  Any subclass
    is automatically registered as a pytree node the first time it is
    defined (via ``__init_subclass__``).
    """

    def __init_subclass__(cls, **kwargs: Any):
        super().__init_subclass__(**kwargs)
        jax.tree_util.register_pytree_with_keys_class(cls)

    # -- pytree protocol ----------------------------------------------------
    #
    # Which attributes are pytree children is decided by *value sniffing* the
    # first time an instance is flattened, then pinned in ``_dyn_keys`` so the
    # partition stays stable when jax.tree_util.tree_map replaces leaves with
    # arbitrary objects (shardings, None, ShapeDtypeStructs, ...).
    def tree_flatten_with_keys(self):
        dyn_keys = self.__dict__.get("_dyn_keys")
        if dyn_keys is None:
            dyn_keys = tuple(sorted(
                k for k, v in self.__dict__.items()
                if not k.startswith("_dyn") and _is_dynamic(v)
            ))
        dyn_items = [(jax.tree_util.GetAttrKey(k), self.__dict__[k]) for k in dyn_keys]
        static_items = tuple(
            (k, _Static(self.__dict__[k]))
            for k in sorted(self.__dict__.keys())
            if k not in dyn_keys and not k.startswith("_dyn")
        )
        aux = (dyn_keys, static_items)
        return dyn_items, aux

    def tree_flatten(self):
        dyn_items, aux = self.tree_flatten_with_keys()
        return [v for _, v in dyn_items], aux

    @classmethod
    def tree_unflatten(cls, aux, children):
        dyn_keys, static_items = aux
        obj = object.__new__(cls)
        for k, v in zip(dyn_keys, children):
            object.__setattr__(obj, k, v)
        for k, sv in static_items:
            object.__setattr__(obj, k, sv.value)
        # Pin the partition: children stay children even if they are now
        # non-array objects (sharding specs, None, ...).
        object.__setattr__(obj, "_dyn_keys", dyn_keys)
        return obj

    # -- functional updates ---------------------------------------------------
    def replace(self, **updates: Any) -> "Module":
        """Return a copy of this module with the given attributes replaced."""
        obj = object.__new__(type(self))
        obj.__dict__.update(self.__dict__)
        obj.__dict__.update(updates)
        obj.__dict__.pop("_dyn_keys", None)  # re-sniff: dynamicity may change
        return obj

    # -- parameter access (parity with reference module.py:26-70) ----------
    def named_parameters(self, prefix: str = "") -> List[Tuple[str, Array]]:
        """Dotted-name list of every array leaf in the tree."""
        out: List[Tuple[str, Array]] = []
        for k in sorted(self.__dict__.keys()):
            v = self.__dict__[k]
            name = f"{prefix}{k}"
            out.extend(_named_parameters_of(v, name))
        return out

    def parameters(self) -> List[Array]:
        return [v for _, v in self.named_parameters()]

    def num_parameters(self) -> int:
        return int(sum(np.prod(p.shape) for p in self.parameters()))

    def modules(self) -> List["Module"]:
        """All submodules (direct and nested), reference module.py:21-24."""
        out: List[Module] = []
        for v in self.__dict__.values():
            out.extend(_modules_of(v))
        return out

    # -- train/eval: functional versions of reference module.py:26-43 ------
    @property
    def training(self) -> bool:
        return self.__dict__.get("_training", True)

    def train(self) -> "Module":
        return _set_mode(self, True)

    def eval(self) -> "Module":
        return _set_mode(self, False)

    def __repr__(self) -> str:
        lines = [type(self).__name__ + "("]
        for k in sorted(self.__dict__.keys()):
            if k.startswith("_"):
                continue
            v = self.__dict__[k]
            if isinstance(v, Module):
                sub = repr(v).replace("\n", "\n  ")
                lines.append(f"  {k}={sub},")
            elif isinstance(v, (jax.Array, np.ndarray)):
                lines.append(f"  {k}=Array{tuple(v.shape)},")
            else:
                lines.append(f"  {k}={v!r},")
        lines.append(")")
        return "\n".join(lines)

    # Modules are callable like the reference's Module.__call__ -> forward.
    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        return self.forward(*args, **kwargs)

    def forward(self, *args: Any, **kwargs: Any) -> Any:  # pragma: no cover
        raise NotImplementedError


def _named_parameters_of(v: Any, name: str) -> List[Tuple[str, Array]]:
    if isinstance(v, Module):
        return [(f"{name}.{n}", p) for n, p in v.named_parameters()]
    if isinstance(v, (jax.Array, np.ndarray)):
        return [(name, v)]
    if isinstance(v, (list, tuple)):
        out: List[Tuple[str, Array]] = []
        for i, x in enumerate(v):
            out.extend(_named_parameters_of(x, f"{name}.{i}"))
        return out
    if isinstance(v, dict):
        out = []
        for k, x in sorted(v.items()):
            out.extend(_named_parameters_of(x, f"{name}.{k}"))
        return out
    return []


def _modules_of(v: Any) -> List[Module]:
    if isinstance(v, Module):
        return [v] + v.modules()
    if isinstance(v, (list, tuple)):
        out: List[Module] = []
        for x in v:
            out.extend(_modules_of(x))
        return out
    if isinstance(v, dict):
        out = []
        for x in v.values():
            out.extend(_modules_of(x))
        return out
    return []


def map_module_tree(v: Any, fn) -> Any:
    """Rebuild a Module/container tree, applying ``fn`` to every Module
    post-order (children already transformed).  ``fn`` may return the module
    unchanged or a replacement of any type.  The single tree-walk shared by
    ``train``/``eval``, :func:`flashattn_tpu.parallel.sharding.apply_mesh`
    and :func:`flashattn_tpu.ops.quant.quantize_model_weights`."""
    if isinstance(v, Module):
        updates = {k: map_module_tree(x, fn) for k, x in v.__dict__.items()
                   if k != "_dyn_keys"}
        return fn(v.replace(**updates))
    if isinstance(v, list):
        return [map_module_tree(x, fn) for x in v]
    if isinstance(v, tuple):
        return tuple(map_module_tree(x, fn) for x in v)
    if isinstance(v, dict):
        return {k: map_module_tree(x, fn) for k, x in v.items()}
    return v


def _set_mode(m: Module, training: bool) -> Module:
    def set_flag(mod: Module) -> Module:
        object.__setattr__(mod, "_training", training)
        return mod

    return map_module_tree(m, set_flag)


# ---------------------------------------------------------------------------
# Parameter-pytree helpers used by optimizers and sharding.
# ---------------------------------------------------------------------------


def tree_arrays(tree: Any):
    """All jax array leaves of a pytree (Modules included)."""
    return [x for x in jax.tree_util.tree_leaves(tree) if isinstance(x, (jax.Array, np.ndarray))]


class Parameter:
    """Thin compatibility shim mirroring reference ``Parameter`` (module.py:138-166).

    In this framework parameters are just arrays in the module pytree; this
    wrapper exists for API familiarity and unwraps transparently.
    """

    def __init__(self, value: Array, name: str | None = None):
        self.value = jnp.asarray(value)
        self.name = name

    def update(self, value: Array) -> None:
        self.value = jnp.asarray(value)

    def __repr__(self) -> str:
        return f"Parameter(shape={tuple(self.value.shape)})"
