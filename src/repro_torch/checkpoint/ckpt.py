"""Atomic, async-capable checkpointing in the JAX package's format.

Layout::

    <dir>/step_<N>/
        manifest.json            # leaf paths, shapes, dtypes, step
        shard_0.npz              # the leaves (flattened), leaf_<i>
    <dir>/step_<N>.COMMITTED     # atomic commit marker (written last)

A tree is written as the JAX package writes the same state: its leaves in
JAX's order (dict keys sorted at every level) under JAX's key paths, so
each package reads the other's checkpoints.  The port's trees hold one
tensor a layer where JAX stacks the layers: a module (its ``state_dict``)
or a mapping keyed by the port's names (the optimizer's moments) is written
as the JAX tree (``models.convert.jax_items``), its layers stacked on save
and unstacked on restore; a ``NamedTuple`` field is the path component
``.<field>`` and a sequence item its index.  So the trainer's carry
``(model, OptState)`` is written as ``0/embed``, ``0/layers/attn/wk`` …
``1/.step``, ``1/.mu/layers/attn/wo`` … ``1/.nu/norm_f``.

Restore fills the template's tensors in place (the model's parameters, the
moments, the step): they are placed already.  A leaf the template holds as
a host value (an array or a scalar) comes back as a numpy array, or, with a
placement for it in ``shardings``, as a tensor on that placement's device.
Writes happen on a background thread (async checkpointing); ``wait()``
joins before the next save or at shutdown.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from collections.abc import Mapping

import numpy as np
import torch
from torch import nn

from ..dist.sharding import place
from ..models.convert import (Stacked, copy_leaf_, jax_items,
                              jax_leaf_index)


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _children(node):
    """(path component, child) of a container node, or None for a leaf."""
    if _is_namedtuple(node):
        return [("." + f, getattr(node, f)) for f in node._fields]
    if isinstance(node, (tuple, list)):
        return [(str(i), v) for i, v in enumerate(node)]
    return None


def flatten(tree) -> list[tuple[str, object]]:
    """(path, leaf) of ``tree`` in JAX's leaf order under JAX's key paths;
    a stacked leaf is one ``Stacked``, ``None`` holds no leaf."""
    out = []

    def walk(node, path):
        if node is None:
            return
        if isinstance(node, nn.Module):
            node = node.state_dict()
        if isinstance(node, Mapping):
            out.extend(("/".join(path + p), leaf)
                       for p, leaf in jax_items(node))
            return
        kids = _children(node)
        if kids is None:
            out.append(("/".join(path), node))
            return
        for name, child in kids:
            walk(child, path + (name,))

    walk(tree, ())
    return out


def tree_paths(tree) -> list[str]:
    return [p for p, _ in flatten(tree)]


def _host(leaf) -> np.ndarray:
    """A copy of a leaf's value in host memory, taken now: the trainer
    updates its tensors in place while an async write runs, and on the CPU
    ``.cpu().numpy()`` alone would share the live tensor's memory."""
    if isinstance(leaf, Stacked):
        leaf = leaf.stack().cpu()               # ``stack`` copies
    elif isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().to("cpu", copy=True)
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise TypeError("a bfloat16 leaf has no numpy dtype to be "
                            "written as")
        return leaf.numpy()
    return np.array(leaf)


def _fill(node, path: tuple, arrays: dict, places: dict):
    """``node`` rebuilt from ``arrays`` (path -> array): tensors filled in
    place, host values replaced."""
    if node is None:
        return None
    if isinstance(node, nn.Module):
        _fill(node.state_dict(), path, arrays, places)
        return node
    if isinstance(node, Mapping):
        return _fill_mapping(node, path, (), arrays, places)
    kids = _children(node)
    if kids is not None:
        vals = [_fill(c, path + (n,), arrays, places) for n, c in kids]
        return type(node)(*vals) if _is_namedtuple(node) else type(node)(vals)
    return _leaf(node, "/".join(path), (), arrays, places)


def _fill_mapping(node: Mapping, path: tuple, prefix: tuple, arrays: dict,
                  places: dict) -> dict:
    out = {}
    for name, child in node.items():
        parts = prefix + tuple(str(name).split("."))
        if isinstance(child, Mapping):
            out[name] = _fill_mapping(child, path, parts, arrays, places)
            continue
        jpath, idx = jax_leaf_index(parts)
        out[name] = _leaf(child, "/".join(path + jpath), idx, arrays, places)
    return out


def _leaf(node, path: str, idx: tuple, arrays: dict, places: dict):
    a = arrays[path][idx] if idx else arrays[path]
    if isinstance(node, torch.Tensor):
        copy_leaf_(node, a)
        return node
    if path in places:
        return place(np.array(a), places[path])
    return a


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None

    # -- save -----------------------------------------------------------------
    def save(self, step: int, tree, blocking: bool = True):
        """Snapshot to host memory synchronously, write to disk (optionally
        on a background thread), commit atomically."""
        self.wait()
        flat = flatten(tree)
        host_leaves = [_host(x) for _, x in flat]   # device -> host now
        manifest = {
            "step": step,
            "leaves": [{"path": p, "shape": list(a.shape),
                        "dtype": str(a.dtype)} for (p, _), a in
                       zip(flat, host_leaves)],
        }

        def write():
            tmp = os.path.join(self.dir, f"step_{step}.tmp")
            final = os.path.join(self.dir, f"step_{step}")
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, "shard_0.npz"),
                     **{f"leaf_{i}": a for i, a in enumerate(host_leaves)})
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            with open(final + ".COMMITTED", "w") as f:
                f.write(str(step))
            self._gc()

        if blocking:
            write()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = sorted(self.committed_steps())
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)
            try:
                os.remove(os.path.join(self.dir, f"step_{s}.COMMITTED"))
            except OSError:
                pass

    # -- restore ----------------------------------------------------------------
    def committed_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.endswith(".COMMITTED"):
                try:
                    out.append(int(name[len("step_"):-len(".COMMITTED")]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.committed_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, target_tree, shardings=None):
        """Rebuild ``target_tree``-structured state: its tensors filled in
        place, its host values replaced (placed by ``shardings``, a tree of
        the same structure whose leaves are placements or devices, where
        given).  The checkpoint's leaf paths must be the template's."""
        final = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(final, "manifest.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(final, "shard_0.npz")) as data:
            arrays = {leaf["path"]: data[f"leaf_{i}"]
                      for i, leaf in enumerate(manifest["leaves"])}
        want = tree_paths(target_tree)
        if sorted(want) != sorted(arrays):
            raise ValueError(
                f"checkpoint step {step} holds leaves "
                f"{sorted(set(arrays) - set(want))} the template lacks and "
                f"lacks {sorted(set(want) - set(arrays))}")
        places = dict(flatten(shardings)) if shardings is not None else {}
        return _fill(target_tree, (), arrays, places), manifest["step"]
