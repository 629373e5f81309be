"""The staged path's sort key and its state row on the CPU.

``key_box`` / ``key_from_box`` (the key kernel's two passes in plain torch)
and ``sort_key`` (their composition) against JAX's ``_sort_key``, exactly,
in every mode, on edge pools: every lane dead, one live lane, origins at
+-0.0 and on the box's faces, NaN and infinities in dead rows, direction
components at exactly 0.  And the key-first row that ``pack_state`` writes.
The key kernel itself is held to these halves on the card
(tests/test_torch_kernels.py, ``test_cuda_key_kernel_*``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bpt_tpu.integrator import IntegratorConfig as JConfig
from bpt_tpu.kernels.megakernel import _sort_key, _state_layout
from bpt_tpu_torch.core.rng import RngState
from bpt_tpu_torch.integrator.radiance import PathState
from bpt_tpu_torch.kernels import staged
from test_torch_kernels import KEY_EDGE_CASES, key_edge_pools, pack_key_state

torch.set_num_threads(2)


def _jax_key(ro, rd, alive, mode) -> np.ndarray:
    layout = _state_layout(JConfig(bounces=4), False)
    planes = np.zeros((len(layout), 1, len(alive)), np.float32)
    for i, axis in enumerate("xyz"):
        planes[layout.index(f"ro{axis}"), 0] = ro[:, i]
        planes[layout.index(f"rd{axis}"), 0] = rd[:, i]
    planes[layout.index("alive"), 0] = alive
    return np.asarray(_sort_key(jnp.asarray(planes), layout, mode))[0]


@pytest.mark.parametrize("mode", staged.KEY_MODES)
@pytest.mark.parametrize("case", KEY_EDGE_CASES)
def test_key_halves_match_jax_on_edge_pools(case, mode):
    """key_from_box over key_box's box, and sort_key, equal JAX's _sort_key
    bit for bit; key_box is the masked min and max (dead lanes +-1e9)."""
    ro, rd, alive = key_edge_pools()[case]
    state = pack_key_state(ro, rd, alive)
    ref = _jax_key(ro, rd, alive, mode)
    lo, hi = staged.key_box(state)
    np.testing.assert_array_equal(lo.numpy(), np.where(alive[:, None], ro, np.float32(1e9)).min(axis=0))
    np.testing.assert_array_equal(hi.numpy(), np.where(alive[:, None], ro, np.float32(-1e9)).max(axis=0))
    np.testing.assert_array_equal(staged.key_from_box(state, lo, hi, mode).numpy(), ref)
    np.testing.assert_array_equal(staged.sort_key(state, mode).numpy(), ref)
    assert bool(((ref == 1 << 30) == ~alive).all())


def test_pack_state_writes_the_key_first_row():
    """pack_state: ro, rd, flags and home in the row's first 32 bytes (words
    0-7), then mask, sharp and the RNG pair, two zero words; a dead lane's
    row all zero."""
    rng = np.random.default_rng(8)
    n = 64

    def floats(*shape):
        return torch.as_tensor(rng.normal(size=shape).astype(np.float32))

    def flags():
        return torch.as_tensor(rng.random(n) < 0.5)

    alive = flags()
    path = PathState(*([None] * 17))._replace(
        ro=floats(n, 3), rd=floats(n, 3), mask=floats(n, 3), sharp=floats(n), alive=alive, spec=flags(),
        sample_light=flags(), coat_hit=flags(), d_count=torch.as_tensor(rng.integers(0, 5, n), dtype=torch.int32),
        prev_mat=torch.as_tensor(rng.integers(-3, 9, n), dtype=torch.int32),
        rng=RngState(torch.as_tensor(rng.integers(0, 2 ** 32, n)), torch.as_tensor(rng.integers(0, 2 ** 32, n))))
    home = torch.as_tensor(rng.permutation(n))
    rows = staged.pack_state(path, home)
    assert (staged.RO_WORD, staged.RD_WORD, staged.FLAGS_WORD, staged.HOME_WORD) == (0, 3, 6, 7)
    assert (staged.MASK_WORD, staged.SHARP_WORD, staged.RNG_WORD) == (8, 11, 12)
    live, f = rows[alive], rows[alive].view(torch.float32)
    for word, value in ((staged.RO_WORD, path.ro), (staged.RD_WORD, path.rd), (staged.MASK_WORD, path.mask)):
        torch.testing.assert_close(f[:, word:word + 3], value[alive], rtol=0, atol=0)
    torch.testing.assert_close(f[:, staged.SHARP_WORD], path.sharp[alive], rtol=0, atol=0)
    flag_bits = (1 | path.spec.int() * 2 | path.sample_light.int() * 4 | path.coat_hit.int() * 8
                 | (path.d_count << 8) | ((path.prev_mat & 0xFFFF) << 16))
    torch.testing.assert_close(live[:, staged.FLAGS_WORD], flag_bits[alive].int(), rtol=0, atol=0)
    torch.testing.assert_close(live[:, staged.HOME_WORD], home[alive].int(), rtol=0, atol=0)
    for k, word in enumerate((path.rng.sx, path.rng.sy)):
        torch.testing.assert_close(live[:, staged.RNG_WORD + k], word[alive].to(torch.int32), rtol=0, atol=0)
    assert bool((live[:, 14:] == 0).all()) and bool((rows[~alive] == 0).all())


def test_key_sweep_needs_a_card(monkeypatch):
    """The key sweep measures on the card only: without one it exits 1; an
    unknown pool is refused."""
    from bpt_tpu_torch.tools import key_sweep

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert key_sweep.main(["--pools", "cornell", "--size", "8"]) == 1
    with pytest.raises(SystemExit):
        key_sweep.main(["--pools", "teapot"])
