"""Carry parameters between the JAX reference and the port.

The port keeps the reference's parameter tree and layouts exactly: hash
tables [rows, F], dense planes [C, H, W] (coordinate c0 on the last axis),
hashed planes [rows, C], MLP weights [in, out] (bias-free), and the U-Net's
{"params", "state"} with OIHW convolution weights. So carrying a tree
across is a leaf-by-leaf copy. This module imports no JAX: the caller turns
a JAX tree into numpy first (e.g. `jax.tree.map(np.asarray, tree)`).
"""

import numpy as np
import torch


def tree_map(fn, *trees):
    """fn applied leaf by leaf to trees of nested dicts / lists / tuples of
    one structure (lists and tuples come back as lists)."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: tree_map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, (list, tuple)):
        return [tree_map(fn, *xs) for xs in zip(*trees)]
    return fn(*trees)


def tree_leaves(tree):
    """The leaves of a tree in the order `jax.tree.leaves` gives them (dict
    keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_paths(tree, prefix=""):
    """The dotted path of each leaf ("hash.static", "sigma.0"), in the
    order of `tree_leaves`."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in tree_paths(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree) for p in tree_paths(v, f"{prefix}{i}.")]
    return [prefix[:-1]]


def tree_to_torch(tree, device):
    """A tree of arrays -> the same tree of float32 tensors on `device`."""
    return tree_map(lambda a: torch.tensor(np.asarray(a, np.float32), device=device), tree)


def tree_to_numpy(tree):
    """A tree of tensors -> the same tree of float32 numpy arrays."""
    return tree_map(lambda t: t.detach().cpu().numpy().astype(np.float32), tree)


def params_from_jax(field, jax_tree):
    """A `LiDAR4DField.init` tree of the JAX package, given as numpy arrays,
    as the port's parameters on `field.device`.

    The tree must have exactly the structure and shapes of the port's own
    init for `field.cfg` (U-Net params and state included); a mismatch
    raises instead of loading weights into the wrong slots.
    """
    want = tree_map(np.shape, field.init(seed=0))
    got = tree_map(np.shape, jax_tree)
    if want != got:
        raise ValueError(f"JAX parameter tree does not match the field:\n{got}\n!=\n{want}")
    return tree_to_torch(jax_tree, field.device)


def stacked_params_from_jax(field, jax_stack):
    """The parameters of the JAX package's `init_multiseq_state` (every leaf
    with a leading [S] axis, given as numpy arrays) as the port's stacked
    parameters on `field.device` (`parallel.multiseq`). Each sequence's
    slice must have exactly the structure and shapes of the port's init for
    `field.cfg`, as in `params_from_jax`."""
    n_seq = {np.shape(a)[0] if np.ndim(a) else None for a in tree_leaves(jax_stack)}
    if len(n_seq) != 1 or None in n_seq:
        raise ValueError(f"not a stack of parameter trees: leading axes {sorted(map(str, n_seq))}")
    s = n_seq.pop()
    want = tree_map(lambda a: (s, *np.shape(a)), field.init(seed=0))
    got = tree_map(np.shape, jax_stack)
    if want != got:
        raise ValueError(f"JAX parameter stack does not match the field:\n{got}\n!=\n{want}")
    return tree_to_torch(jax_stack, field.device)
