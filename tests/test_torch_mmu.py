"""The port's MMU: the copied host half passes the reference's TLB tests
(``tests/test_mmu_tlb.py``), and the torch ``DeviceBlockTable`` passes
the incremental and eviction block-table tests of
``tests/test_decode_hot_path.py``, on the CPU."""
import numpy as np
import pytest
import torch

from repro.core.services import mmu as JM
from repro_torch.core.services.mmu import MMU, MMUConfig, TLB

# small shapes: one intra-op thread is faster and leaves the cores to
# the other test workers
torch.set_num_threads(1)


def test_host_half_is_the_reference_copy():
    """Same config defaults and the same page-table answers on a script
    of alloc/extend/share/evict/free operations."""
    assert MMUConfig() == MMUConfig(**JM.MMUConfig().__dict__)
    outs = []
    for mod in (JM, None):
        m = (JM.MMU(JM.MMUConfig(page_size=4, n_pages=6, host_pool_pages=8))
             if mod else MMU(MMUConfig(page_size=4, n_pages=6,
                                       host_pool_pages=8)))
        prompt = list(range(8))
        m.alloc_seq(1, 8, prompt_tokens=prompt)
        m.alloc_seq(2, 9, prompt_tokens=prompt)
        m.extend_seq(1, 5)
        m.alloc_seq(3, 8)                  # forces eviction
        outs.append((m.block_table([1, 2, 3], 6).tolist(),
                     m.seq_lens([1, 2, 3]).tolist(), m.utilization()))
        m.free_seq(2)
        outs.append((m.block_table([1, 3], 6).tolist(), m.utilization()))
    assert outs[:2] == outs[2:]


def test_lookup_miss_then_insert_then_hit():
    tlb = TLB(entries=16, assoc=4)
    assert tlb.lookup(1, 0) is None
    tlb.insert(1, 0, 7)
    assert tlb.lookup(1, 0) == 7
    assert (tlb.hits, tlb.misses) == (1, 1)


def test_insert_same_key_updates_in_place():
    tlb = TLB(entries=16, assoc=4)
    tlb.insert(1, 0, 7)
    tlb.insert(1, 0, 9)
    assert tlb.lookup(1, 0) == 9
    assert sum(len(s) for s in tlb._sets) == 1


def test_distinct_keys_do_not_alias():
    tlb = TLB(entries=64, assoc=4)
    for sid in range(4):
        for vp in range(4):
            tlb.insert(sid, vp, sid * 100 + vp)
    for sid in range(4):
        for vp in range(4):
            assert tlb.lookup(sid, vp) == sid * 100 + vp


def test_lru_eviction_within_a_set():
    tlb = TLB(entries=4, assoc=4)
    for vp in range(4):
        tlb.insert(1, vp, vp)
    assert tlb.lookup(1, 0) == 0
    tlb.insert(1, 99, 99)
    assert tlb.lookup(1, 1) is None
    assert tlb.lookup(1, 0) == 0
    assert tlb.lookup(1, 99) == 99


def test_assoc_clamped_and_capacity_never_exceeded():
    tlb = TLB(entries=2, assoc=8)
    assert (tlb.assoc, tlb.n_sets) == (2, 1)
    tlb = TLB(entries=8, assoc=0)
    assert (tlb.assoc, tlb.n_sets) == (1, 8)
    tlb = TLB(entries=8, assoc=2)
    for vp in range(64):
        tlb.insert(3, vp, vp)
    assert sum(len(s) for s in tlb._sets) <= 8
    assert all(len(s) <= tlb.assoc for s in tlb._sets)


def test_invalidate_scopes_to_one_sequence():
    tlb = TLB(entries=32, assoc=4)
    for vp in range(4):
        tlb.insert(1, vp, vp)
        tlb.insert(2, vp, 100 + vp)
    assert tlb.invalidate(1) == 4
    assert tlb.invalidate(42) == 0
    for vp in range(4):
        assert tlb.lookup(1, vp) is None
        assert tlb.lookup(2, vp) == 100 + vp


def test_hit_rate_accounting():
    tlb = TLB(entries=16, assoc=4)
    assert tlb.hit_rate == 1.0
    tlb.lookup(1, 0)
    tlb.insert(1, 0, 3)
    tlb.lookup(1, 0)
    tlb.lookup(1, 0)
    assert tlb.hits == 2 and tlb.misses == 1
    assert tlb.hit_rate == pytest.approx(2 / 3)


def test_cow_remap_invalidates_stale_translation():
    mmu = MMU(MMUConfig(page_size=4, n_pages=16, host_pool_pages=16))
    store = {}
    mmu.register_pager(lambda pp: store.get(pp),
                       lambda pp, d: store.__setitem__(pp, d), owner="t")
    prompt = list(range(8))
    mmu.alloc_seq(1, 8, prompt_tokens=prompt)
    assert mmu.alloc_seq(2, 8, prompt_tokens=prompt) == 8
    shared = mmu.translate(2, 0)[0]
    new_pp = mmu.translate(2, 0, for_write=True)[0]
    assert new_pp != shared
    assert mmu.translate(2, 0)[0] == new_pp
    assert mmu.translate(1, 0)[0] == shared


def test_device_block_table_is_incremental():
    mmu = MMU(MMUConfig(page_size=4, n_pages=64))
    bt = mmu.block_table_device(n_slots=2, max_pages=8, device="cpu")
    mmu.alloc_seq(1, 6)                      # 2 pages
    bt.bind(0, 1)
    t0 = bt.device_view()
    assert t0.dtype == torch.int32 and t0.is_contiguous()
    np.testing.assert_array_equal(t0.numpy()[0], mmu.block_table([1], 8)[0])
    assert t0[1][0] == -1
    up0 = bt.row_uploads
    mmu.extend_seq(1, 1)                     # 7 tokens, still 2 pages
    for _ in range(3):
        assert bt.device_view() is t0        # cache hit: same tensor
    assert bt.row_uploads == up0
    assert bt.hits >= 3
    mmu.extend_seq(1, 2)                     # 9 tokens -> 3rd page
    t1 = bt.device_view()
    assert bt.row_uploads == up0 + 1
    assert bt.last_updated_rows == [0]
    np.testing.assert_array_equal(t1.numpy()[0], mmu.block_table([1], 8)[0])
    mmu.free_seq(1)
    bt.unbind(0)
    assert (bt.device_view().numpy()[0] == -1).all()


def test_device_block_table_tracks_eviction():
    mmu = MMU(MMUConfig(page_size=4, n_pages=4, host_pool_pages=16))
    bt = mmu.block_table_device(n_slots=2, max_pages=8, device="cpu")
    mmu.alloc_seq(1, 12)                     # 3 of 4 pages
    bt.bind(0, 1)
    bt.device_view()
    mmu.alloc_seq(2, 8)                      # forces eviction of seq 1 tail
    bt.bind(1, 2)
    t = bt.device_view().numpy()
    np.testing.assert_array_equal(t, mmu.block_table([1, 2], 8))
    assert (t[0] == -1).sum() >= 6


def test_device_block_table_needs_the_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MMU(MMUConfig()).block_table_device(2, 4)
