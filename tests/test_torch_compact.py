"""K1's row-table entry and the stage that calls it, on the CPU: the port's
``compact_rows`` (plain version) and ``stream_compact_to`` against the
reference's ``masked_compact_pallas`` and ``stream_compact_to`` in
interpret mode, single-scan, with more rows than one reference launch
takes, and with a batch axis (the reference under ``jax.vmap``). The same
numpy inputs, made from a seed, go to both. Live columns are compared bit
for bit, the zeros past the count and the output mask exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autodriver_pointcloud_preprocessor_tpu.core.scan import ScanBuffer as RefScanBuffer
from autodriver_pointcloud_preprocessor_tpu.ops.compact import (
    stream_compact_to as ref_stream_compact_to,
)
from autodriver_pointcloud_preprocessor_tpu.ops.pallas_segmean import masked_compact_pallas
from autodriver_pointcloud_preprocessor_tpu_torch.convert import scan_from_reference
from autodriver_pointcloud_preprocessor_tpu_torch.ops.compact import stream_compact_to
from autodriver_pointcloud_preprocessor_tpu_torch.ops.segmean import (
    compact_rows,
    compact_rows_plain,
    masked_compact,
)


def _mask(kind, n, rng):
    if kind == "all":
        return np.ones(n, bool)
    if kind == "none":
        return np.zeros(n, bool)
    if kind == "one":
        m = np.zeros(n, bool)
        m[n - 5] = True
        return m
    if kind == "runs":  # long live and dead runs across 1024-column edges
        m = np.zeros(n, bool)
        for lo, hi in ((100, 1500), (2040, 2050), (3000, 4096)):
            m[lo:hi] = True
        return m
    return rng.uniform(size=n) < 0.4


@pytest.mark.parametrize("kind", ["random", "all", "none", "one", "runs"])
def test_compact_rows_matches_masked_compact_pallas(kind):
    rng = np.random.default_rng(len(kind))
    n, cap = 4096, 2048
    mask = _mask(kind, n, rng)
    pos = rng.normal(0, 10, (3, n)).astype(np.float32)
    extra = rng.normal(0, 1, (2, 2, n)).astype(np.float32)
    ring = rng.integers(0, 32, n).astype(np.int32)
    pos[:, ~mask] = np.nan  # dead columns hold NaN, as in the pipeline
    stacked = np.concatenate([pos, extra.reshape(4, n), ring[None].astype(np.float32)])
    ref = np.asarray(masked_compact_pallas(jnp.asarray(stacked), jnp.asarray(mask), interpret=True))

    outs, mask_out = compact_rows(
        [torch.from_numpy(pos), torch.from_numpy(extra), torch.from_numpy(ring)],
        torch.from_numpy(mask), cap,
    )
    live = min(int(mask.sum()), cap)
    assert [tuple(o.shape) for o in outs] == [(3, cap), (2, 2, cap), (cap,)]
    assert outs[2].dtype == torch.int32
    got = np.concatenate([outs[0].numpy(), outs[1].numpy().reshape(4, cap)])
    np.testing.assert_array_equal(got[:, :live].view(np.int32), ref[:7, :live].view(np.int32))
    np.testing.assert_array_equal(outs[2].numpy()[:live], ref[7, :live].astype(np.int32))
    assert (got[:, live:] == 0).all() and (outs[2].numpy()[live:] == 0).all()
    np.testing.assert_array_equal(mask_out.numpy(), np.arange(cap) < live)
    # masked_compact is the same entry over one tensor's rows
    one = masked_compact(torch.from_numpy(pos), torch.from_numpy(mask), cap)
    assert torch.equal(one.view(torch.int32), outs[0].view(torch.int32))


def _ref_and_port_buffers(rng, lead, n, densities):
    """The same channel-major arrays as a reference and a port buffer:
    positions, intensity, ring, normals [3, N] and an int32 label (more than
    8 rows; the reference carries the label as two 16-bit halves)."""
    pos = rng.normal(0, 20, lead + (3, n)).astype(np.float32)
    mask = rng.uniform(size=lead + (n,)) < np.asarray(densities).reshape(lead + (1,))
    attrs = {
        "intensity": rng.uniform(0, 255, lead + (n,)).astype(np.float32),
        "ring": rng.integers(0, 32, lead + (n,)).astype(np.int32),
        "normals": rng.normal(0, 1, lead + (3, n)).astype(np.float32),
        "label": rng.integers(-(2 ** 30), 2 ** 30, lead + (n,)).astype(np.int32),
    }
    pos[np.broadcast_to(~mask[..., None, :], pos.shape)] = np.nan
    port = scan_from_reference(pos, mask, attrs, device="cpu")
    return (pos, mask, attrs), port


def _assert_same(port, ref_pos, ref_mask, ref_attrs, cap):
    np.testing.assert_array_equal(port.mask.numpy(), ref_mask)
    np.testing.assert_array_equal(port.positions.numpy().view(np.int32), ref_pos.view(np.int32))
    for name, want in ref_attrs.items():
        got = port.attributes[name].numpy()
        assert got.shape == want.shape and got.dtype == want.dtype, name
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32), err_msg=name)
    dead = ~port.mask.numpy()
    assert (port.positions.numpy().swapaxes(-2, -1)[dead] == 0).all()
    assert all((v.numpy()[..., dead] == 0).all() if v.dim() == port.mask.dim()
               else (v.numpy().swapaxes(-2, -1)[dead] == 0).all()
               for v in port.attributes.values())


def test_stream_compact_to_more_than_8_rows_matches_reference():
    rng = np.random.default_rng(51)
    n, cap = 4096, 2048
    (pos, mask, attrs), port_buf = _ref_and_port_buffers(rng, (), n, 0.45)
    ref = ref_stream_compact_to(
        RefScanBuffer(jnp.asarray(pos), jnp.asarray(mask), {k: jnp.asarray(v) for k, v in attrs.items()}),
        cap, backend="pallas_interpret",
    )
    port = stream_compact_to(port_buf, cap)
    assert sum(v.numel() // n for v in port_buf.attributes.values()) + 3 == 9
    _assert_same(port, np.asarray(ref.positions), np.asarray(ref.mask),
                 {k: np.asarray(v) for k, v in ref.attributes.items()}, cap)


def test_stream_compact_to_batch_matches_reference_vmap():
    rng = np.random.default_rng(52)
    n, cap = 2048, 1024
    densities = [0.0, 0.45, 1.0]  # none live; some; more live than the capacity
    (pos, mask, attrs), port_buf = _ref_and_port_buffers(rng, (3,), n, densities)

    def one(p, m, a):
        out = ref_stream_compact_to(RefScanBuffer(p, m, a), cap, backend="pallas_interpret")
        return out.positions, out.mask, out.attributes

    ref_pos, ref_mask, ref_attrs = jax.vmap(one)(
        jnp.asarray(pos), jnp.asarray(mask), {k: jnp.asarray(v) for k, v in attrs.items()})
    port = stream_compact_to(port_buf, cap)
    assert port.mask.sum(-1).tolist() == [0, int(mask[1].sum()), cap]
    _assert_same(port, np.asarray(ref_pos), np.asarray(ref_mask),
                 {k: np.asarray(v) for k, v in ref_attrs.items()}, cap)
    # each scan equals its own compaction
    for i in range(3):
        alone, alone_mask = compact_rows_plain([port_buf.positions[i]], port_buf.mask[i], cap)
        assert torch.equal(alone[0].view(torch.int32), port.positions[i].view(torch.int32))
        assert torch.equal(alone_mask, port.mask[i])


@pytest.mark.parametrize("case", ["no_sources", "bad_dtype", "lead_mismatch", "capacity", "devices"])
def test_compact_rows_rejects_bad_inputs(case):
    n = 512
    mask = torch.ones((2, n), dtype=torch.bool)
    good = torch.zeros((2, 3, n))
    args = {
        "no_sources": ([], mask, n),
        "bad_dtype": ([good.double()], mask, n),
        "lead_mismatch": ([torch.zeros((3, 3, n))], mask, n),
        "capacity": ([good], mask, n + 1),
        "devices": ([good.to("meta")], mask, n),
    }[case]
    with pytest.raises(ValueError):
        compact_rows(*args)
