"""The traffic generators repeat exactly from a seed, and every seed
serves the same sizes."""
import numpy as np

from chipbench import harness, traffic

CHAT = harness.workload("zamba2-1.2b.chat")["traffic"]
RAG = harness.workload("rwkv6-1.6b-fp32.rag")["traffic"]


def _stream(tr, seed, n=6):
    loop = traffic.ClosedLoop(tr, 32000, seed)
    return [[loop.next(c) for _ in range(n)] for c in range(loop.clients)]


def test_a_seed_repeats_exactly():
    a, b = _stream(CHAT, 2**31 + 11), _stream(CHAT, 2**31 + 11)
    for ra, rb in zip(sum(a, []), sum(b, [])):
        assert np.array_equal(ra.prompt, rb.prompt) and ra.n_out == rb.n_out


def test_seeds_change_ids_not_sizes():
    a, b = _stream(RAG, 5), _stream(RAG, 6)
    for ra, rb in zip(sum(a, []), sum(b, [])):
        assert (len(ra.prompt), ra.n_out) == (len(rb.prompt), rb.n_out)
    assert not np.array_equal(a[0][0].prompt[:50], b[0][0].prompt[:50])
    for j in range(6):      # at every j the clients hold every stratum
        assert sorted(len(r[j].prompt) for r in a) == \
            traffic.ClosedLoop(RAG, 65536, 5).prompts


def test_grids_cover_the_stated_ranges():
    g = traffic.grid({"dist": "uniform", "lo": 2048, "hi": 8192}, 64)
    assert g[0] == 2096 and g[-1] == 8144 and len(set(g)) == 64
    assert abs(np.mean(g) - 5120) < 1
    lg = traffic.grid({"dist": "loguniform", "lo": 64, "hi": 512}, 64)
    assert 64 < lg[0] < 67 and 490 < lg[-1] < 512
    assert all(x < y for x, y in zip(lg, lg[1:]))


def test_each_client_walks_every_stratum():
    loop = traffic.ClosedLoop(RAG, 65536, 9)
    lens = [len(loop.request(0, j).prompt) for j in range(64)]
    assert sorted(lens) == sorted(loop.prompts)
    assert abs(np.mean(lens[:8]) - np.mean(loop.prompts)) < 0.1 * 5120

