"""K1's leaf table, checked without a card.

``kernels/trigger_norms.py::trigger_table_args`` builds the table that
K1's leaf-table kernel (``csrc/fedback_kernels.cu::trigger_table_kernel``)
reads from its parameters: row blocks (one per shard of a device) and,
for each, the stacked tree's leaves as columns [begin, end) of a virtual
row, with their pointers, row strides and dtypes.  Here the table is
built from CPU tensors and walked the way the kernel walks it — group of
4 columns by group, a cursor per row that only moves forward, each
element read at its leaf's pointer, row stride and dtype — and the rows
it yields must equal ``flatten_stacked`` bit for bit.  Also: the
grouping of a mesh's shards by device, the cap on the table's size,
which leaves the wrapper must copy, and K1a's plain version (bf16 z and
ω) against the Pallas kernel in interpret mode.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro_torch.kernels import ops
from repro_torch.kernels import trigger_norms as tn
from repro_torch.kernels.trigger_pytree import table_block
from repro_torch.sharding import ClientMesh, make_client_mesh, \
    replicate_data, shard_rows
from repro_torch.utils.pytree import flatten, flatten_stacked, tree_leaves

# The paper models' leaves (shape without the client axis): the MNIST
# MLP's 4 and the CIFAR CNN's 12 (HWIO kernels).
MLP = {"fc1": {"w": (784, 200), "b": (200,)},
       "fc2": {"w": (200, 10), "b": (10,)}}
CNN = {"conv1": {"w": (3, 3, 3, 32), "b": (32,)},
       "conv2": {"w": (3, 3, 32, 64), "b": (64,)},
       "conv3": {"w": (3, 3, 64, 64), "b": (64,)},
       "fc1": {"w": (1024, 128), "b": (128,)},
       "fc2": {"w": (128, 64), "b": (64,)},
       "fc3": {"w": (64, 10), "b": (10,)}}
# Widths whose groups of 4 straddle leaves: 1, 3, 5 and 4097 columns.
ODD = {"a": (1,), "b": (3,), "c": (5,), "d": (4097,), "e": (2, 7)}


def _tree(rng, shapes, n, bf16=()):
    """A stacked tree (n, ...) and its ω, the leaves named in ``bf16``
    (top-level keys) in bf16."""
    def leaf(shape, key):
        t = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
        return t.to(torch.bfloat16) if key in bf16 else t

    def build(spec, stacked):
        return {k: build(v, stacked) if isinstance(v, dict) else
                leaf(((n,) if stacked else ()) + v, k)
                for k, v in spec.items()}

    return build(shapes, True), build(shapes, False)


def _storage_of(ptr, tensors):
    """A flat view of the storage that holds ``ptr``, of ``tensors``'
    element type, starting at ``ptr``: what the kernel dereferences."""
    for t in tensors:
        base = t.untyped_storage().data_ptr()
        nbytes = t.untyped_storage().nbytes()
        if base <= ptr < base + nbytes:
            size = t.element_size()
            off = (ptr - base) // size
            return torch.as_strided(t, ((nbytes // size) - off,), (1,), off)
    raise AssertionError(f"no tensor holds {ptr:#x}")


def _walk(table, tensors, dtype_of):
    """The rows of every row block as the kernel reads them: columns in
    groups of 4, a cursor on the current leaf that only moves forward,
    each element at its leaf's pointer + row · stride + (column −
    begin), widened from its dtype to fp32.  Returns (the rows, each
    block's ω row)."""
    d, n_blocks = table.d, len(table.rows) - 1
    out = np.empty((table.rows[-1], d), np.float32)
    omega = np.empty((n_blocks, d), np.float32)
    for s in range(n_blocks):
        leaves = table.leaves[s * table.n_leaves:(s + 1) * table.n_leaves]
        which, cursor = np.empty(d, np.int64), 0
        for g in range(-(-d // 4)):
            for c in range(4 * g, min(4 * g + 4, d)):
                while c >= leaves[cursor][4]:
                    cursor += 1
                which[c] = cursor
        for leaf, (zp, wp, z_row, begin, _, bits) in enumerate(leaves):
            cols = np.nonzero(which == leaf)[0]
            z = _storage_of(zp, tensors[dtype_of(bits & tn.Z_BF16)])
            w = _storage_of(wp, tensors[dtype_of(bits & tn.W_BF16)])
            z, w = z.float().numpy(), w.float().numpy()
            for r in range(table.rows[s + 1] - table.rows[s]):
                out[table.rows[s] + r, cols] = z[r * z_row + cols - begin]
            omega[s, cols] = w[cols - begin]
    return torch.from_numpy(out), torch.from_numpy(omega)


def _table_of(trees):
    """The table of one launch over ``trees`` (stacked tree, ω) blocks,
    and the tensors it points into, by dtype."""
    blocks = [table_block(z, w) for z, w in trees]
    table = tn.trigger_table_args([(zs, ws) for zs, ws, _ in blocks])
    leaves = [x for zs, ws, _ in blocks for x in zs + ws]
    by = {torch.float32: [x for x in leaves if x.dtype == torch.float32],
          torch.bfloat16: [x for x in leaves if x.dtype == torch.bfloat16]}
    return table, by, sum(c for _, _, c in blocks)


def _dtype_of(bit):
    return torch.bfloat16 if bit else torch.float32


@pytest.mark.parametrize("shapes,n,bf16", [
    (ODD, 3, ()), (ODD, 2, ("d",)), (ODD, 1, ("a", "c")),
    ({"x": (6,), "y": (2,)}, 4, ("y",))],
    ids=["odd", "odd_bf16_wide", "odd_bf16_narrow", "two_leaves"])
def test_walk_of_the_table_is_flatten_stacked(shapes, n, bf16):
    rng = np.random.default_rng(n + len(bf16))
    z, w = _tree(rng, shapes, n, bf16)
    table, by, copies = _table_of([(z, w)])
    assert copies == 0
    rows, omega = _walk(table, by, _dtype_of)
    assert torch.equal(rows, flatten_stacked(z))
    assert torch.equal(omega[0], flatten(w))


@pytest.mark.parametrize("bf16", [False, True])
def test_walk_reads_strided_leaves_in_place(bf16):
    """Leaves read in place at their own row stride: a column slice
    (rows padded to 9 columns), a leaf broadcast over the clients
    (row stride 0) and a view 4 bytes into its storage."""
    dtype = torch.bfloat16 if bf16 else torch.float32
    z = {"a": torch.randn(5, 9)[:, 2:8].to(dtype),
         "b": torch.randn(7).expand(5, 7),
         "c": torch.randn(5 * 3 + 1)[1:].view(5, 3)}
    w = {"a": torch.randn(6), "b": torch.randn(7).to(dtype),
         "c": torch.randn(3)}
    if bf16:
        z["a"] = torch.randn(5, 9).to(dtype)[:, 2:8]
    table, by, copies = _table_of([(z, w)])
    assert copies == 0
    assert [e[2] for e in table.leaves] == [9, 0, 3]
    rows, omega = _walk(table, by, _dtype_of)
    assert torch.equal(rows, flatten_stacked(z))
    assert torch.equal(omega[0], flatten(w))


@pytest.mark.parametrize("shapes", [MLP, CNN], ids=["mlp", "cnn"])
def test_table_columns_are_the_concatenation_s(shapes):
    """Each leaf's [begin, end) is where the concatenation puts it, its
    width numel / N; the ω and z pointers are the leaves' own (no copy);
    the virtual row's (S, G) are K1's of D."""
    rng = np.random.default_rng(len(shapes))
    z, w = _tree(rng, shapes, 5, ("fc1",))
    table, _, copies = _table_of([(z, w)])
    z_leaves, w_leaves = tree_leaves(z), tree_leaves(w)
    widths = [x.numel() for x in w_leaves]
    starts = np.cumsum([0] + widths)
    assert copies == 0 and table.n_leaves == len(z_leaves)
    assert table.d == flatten(w).shape[0] == sum(widths)
    assert (table.segs, table.seg_groups) == tn.trigger_segments(table.d)
    assert table.rows == (0, 5)
    for (zp, wp, z_row, begin, end, bits), zl, wl, a, b in zip(
            table.leaves, z_leaves, w_leaves, starts[:-1], starts[1:],
            strict=True):
        assert (zp, wp) == (zl.data_ptr(), wl.data_ptr())
        assert (z_row, begin, end) == (zl.numel() // 5, a, b)
        assert bits == (3 if zl.dtype == torch.bfloat16 else 0)


def test_dtype_bits_and_refused_dtypes():
    z, w = torch.zeros(2, 3), torch.zeros(3)
    for zt, wt, bits in ((torch.float32, torch.float32, 0),
                         (torch.bfloat16, torch.float32, tn.Z_BF16),
                         (torch.float32, torch.bfloat16, tn.W_BF16),
                         (torch.bfloat16, torch.bfloat16, 3)):
        table = tn.trigger_table_args([([z.to(zt)], [w.to(wt)])])
        assert table.leaves[0][5] == bits
    for dtype in (torch.float64, torch.float16):
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            tn.trigger_table_args([([z.to(dtype)], [w])])


def test_mismatched_leaves_raise():
    z, w = torch.zeros(2, 3), torch.zeros(3)
    with pytest.raises(ValueError, match="omega must be a \\(3,\\)"):
        tn.trigger_table_args([([z], [w]), ([z], [torch.zeros(4)])])
    with pytest.raises(ValueError, match="unit inner stride"):
        tn.trigger_table_args([([torch.zeros(3, 2).t()], [torch.zeros(3)])])
    with pytest.raises(ValueError, match="stacked copies"):
        table_block({"a": torch.zeros(2, 3)}, {"a": torch.zeros(4)})
    with pytest.raises(ValueError, match="leaves"):
        table_block({"a": z, "b": z}, {"a": w})


@pytest.mark.parametrize("p", [1, 2, 4])
def test_row_blocks_grouped_by_device(p):
    """A mesh's shards go to one launch per device, in shard order,
    each a row block of its own rows: on one device, offsets N/P apart;
    over two devices alternating, each device's blocks in turn."""
    n, d = 12, 7
    one = make_client_mesh(p, ["cpu"])
    shards = shard_rows(torch.randn(n, d), one)
    assert tn.group_by_device(shards) == {torch.device("cpu"): list(range(p))}
    table = tn.trigger_table_args([([z], [torch.zeros(d)]) for z in shards])
    assert table.rows == tuple(range(0, n + 1, n // p))
    assert [e[0] for e in table.leaves] == [z.data_ptr() for z in shards]
    two = ClientMesh(tuple(torch.device("meta" if i % 2 else "cpu")
                           for i in range(p)))
    parts = [torch.empty(n // p, d, device=dev) for dev in two.devices]
    groups = tn.group_by_device(parts)
    assert groups == ({torch.device("cpu"): list(range(0, p, 2)),
                       torch.device("meta"): list(range(1, p, 2))}
                      if p > 1 else {torch.device("cpu"): [0]})


def test_table_cap_raises_before_a_launch():
    w = torch.zeros(2)
    leaf = torch.zeros(1, 2)
    tn.trigger_table_args([([leaf] * 10, [w] * 10)] * 64)  # 640 entries
    with pytest.raises(ValueError, match=f"{tn.PARAM_BYTES} bytes"):
        tn.trigger_table_args([([leaf] * 10, [w] * 10)] * 65)
    with pytest.raises(ValueError, match="640 leaves"):
        tn.trigger_table_args([([leaf] * 641, [w] * 641)])
    # What the rounds launch lies far below the cap: the CNN's 12 leaves
    # on 4 shards of a card.
    assert 4 * 12 <= tn.TABLE_MAX_ENTRIES and 4 <= tn.TABLE_MAX_SHARDS


# Leaves (n = 4) and whether the kernel can read them in place.
COPY_CASES = [
    ("contiguous", lambda: torch.randn(4, 3, 5), False),
    ("column slice (padded rows)", lambda: torch.randn(4, 9)[:, :6], False),
    ("broadcast over clients", lambda: torch.randn(6).expand(4, 6), False),
    ("a view 4 bytes in", lambda: torch.randn(4 * 6 + 1)[1:].view(4, 6),
     False),
    ("transposed inner dims", lambda: torch.randn(4, 5, 3).transpose(1, 2),
     True),
    ("every other column", lambda: torch.randn(4, 12)[:, ::2], True),
    ("one column, any stride", lambda: torch.randn(4, 7)[:, 2:3], False),
]


@pytest.mark.parametrize("make,copied", [(m, c) for _, m, c in COPY_CASES],
                         ids=[name for name, _, _ in COPY_CASES])
def test_which_leaves_need_the_contiguous_copy(make, copied):
    x = make()
    m, was_copied = tn.leaf_view(x, 4, -1)
    assert was_copied == copied
    assert m.shape == (4, x[0].numel()) and torch.equal(m, x.reshape(4, -1))
    assert m.shape[1] <= 1 or m.stride(1) == 1
    if not copied:
        assert m.data_ptr() == x.data_ptr()
    v, v_copied = tn.leaf_view(x[0], -1)
    assert torch.equal(v, x[0].reshape(-1)) and v_copied == copied


def test_the_round_state_needs_no_copy():
    """A tree round's state (stacked leaves and its shards) is read in
    place: the walk of its table equals the concatenation."""
    rng = np.random.default_rng(9)
    z, w = _tree(rng, MLP, 8)
    mesh = make_client_mesh(2, ["cpu"])
    blocks = list(zip(shard_rows(z, mesh), replicate_data(mesh, w),
                      strict=True))
    table, by, copies = _table_of(blocks)
    assert copies == 0 and table.rows == (0, 4, 8)
    rows, omega = _walk(table, by, _dtype_of)
    assert torch.equal(rows, flatten_stacked(z))
    assert torch.equal(omega[1], flatten(w))


@pytest.mark.parametrize("shapes", [MLP, CNN], ids=["mlp", "cnn"])
def test_walk_equals_flatten_stacked_at_the_paper_shapes(shapes):
    """The MLP's and the CNN's leaves (fc1/w in bf16), walked group by
    group at N = 1, bit-equal to ``flatten_stacked``."""
    rng = np.random.default_rng(len(shapes) + 1)
    z, w = _tree(rng, shapes, 1, ("fc1",))
    table, by, _ = _table_of([(z, w)])
    rows, omega = _walk(table, by, _dtype_of)
    assert torch.equal(rows, flatten_stacked(z))
    assert torch.equal(omega[0], flatten(w))


@pytest.mark.parametrize("n,d", [(1, 130), (7, 1001), (12, 4099)])
def test_k1a_plain_version_on_bf16_matches_pallas(n, d):
    """K1a: bf16 z and ω through the port's plain version against the
    Pallas kernel in interpret mode; both widen exactly and sum in
    fp32, in another order (rtol 1e-5, atol 1e-5·√D)."""
    rng = np.random.default_rng(n * d)
    z = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.normal(size=d).astype(np.float32)
    zb, wb = (torch.from_numpy(x).to(torch.bfloat16) for x in (z, w))
    want = np.asarray(jax_ops.trigger_sq_norms(
        jnp.asarray(z, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
        interpret=True))
    ops.reset_launch_counts()
    got = ops.trigger_sq_norms(zb, wb)
    assert got.dtype == torch.float32 and got.shape == (n,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.sqrt(d))
    assert torch.equal(got, ops.trigger_sq_norms_ref(zb.float(), wb.float()))
    assert all(v == 0 for v in ops.launch_counts().values())
