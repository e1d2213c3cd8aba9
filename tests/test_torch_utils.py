"""The port's ``raydp_tpu_torch/utils.py``: the reference's seven
``tests/test_utils.py`` cases with the same assertions, then the port held
to :mod:`raydp_tpu.utils` exactly — ``parse_memory_size``,
``memory_string`` and ``divide_blocks`` over those cases' inputs, and
``get_node_address`` and ``find_free_port``. ``get_node_address``'s route
lookup runs against a stand-in socket: no test opens a route to an outside
address."""

import math
import socket

import pytest

from raydp_tpu_torch import utils as port_utils
from raydp_tpu_torch.utils import divide_blocks, memory_string, parse_memory_size

#: every size string and number the reference's cases parse
MEMORY_INPUTS = [1024, "1024", "1024B", "1k", "1KB", "1.5 GB", "2g", "1T",
                 "512MB", "1GB", "300"]
#: every (blocks, world_size, shuffle, seed) the reference's cases divide
DIVIDE_INPUTS = [
    ([10, 10, 10, 10], 2, False, None),
    ([10, 10, 10, 10], 4, False, None),
    ([7, 3, 11, 2, 5], 2, False, None),
    ([7, 3, 11, 2, 5], 3, False, None),
    ([1, 1, 1, 100], 3, False, None),
    ([5, 6, 7], 2, False, None),
    ([4, 5, 6, 7, 8, 9], 3, True, 42),
    ([4, 5, 6, 7, 8, 9], 3, True, 7),
]


# ---------------------------------------------------------------------------
# the reference's cases (tests/test_utils.py), on the port
# ---------------------------------------------------------------------------

def test_parse_memory_size():
    assert parse_memory_size(1024) == 1024
    assert parse_memory_size("1024") == 1024
    assert parse_memory_size("1024B") == 1024
    assert parse_memory_size("1k") == 1024
    assert parse_memory_size("1KB") == 1024
    assert parse_memory_size("1.5 GB") == int(1.5 * 2**30)
    assert parse_memory_size("2g") == 2 * 2**30
    assert parse_memory_size("1T") == 2**40
    with pytest.raises(ValueError):
        parse_memory_size("12XB")


def test_memory_string_roundtrip():
    for s in ["512MB", "1GB", "300"]:
        assert parse_memory_size(memory_string(parse_memory_size(s))) == \
            parse_memory_size(s)


def _check_equal_share(blocks, world_size, shuffle=False, seed=None):
    result = divide_blocks(blocks, world_size, shuffle=shuffle, shuffle_seed=seed)
    assert set(result.keys()) == set(range(world_size))
    expected = math.ceil(sum(blocks) / world_size)
    for rank, selected in result.items():
        total = sum(n for _, n in selected)
        assert total == expected, f"rank {rank} got {total} != {expected}"
        for idx, n in selected:
            assert 0 <= idx < len(blocks)
            assert 0 < n <= blocks[idx]


def test_divide_blocks_even():
    _check_equal_share([10, 10, 10, 10], 2)
    _check_equal_share([10, 10, 10, 10], 4)


def test_divide_blocks_uneven():
    _check_equal_share([7, 3, 11, 2, 5], 2)
    _check_equal_share([7, 3, 11, 2, 5], 3)
    _check_equal_share([1, 1, 1, 100], 3)


def test_divide_blocks_wraparound():
    # more ranks than evenly divisible blocks → wraparound duplication
    _check_equal_share([5, 6, 7], 2)


def test_divide_blocks_shuffle_deterministic():
    a = divide_blocks([4, 5, 6, 7, 8, 9], 3, shuffle=True, shuffle_seed=42)
    b = divide_blocks([4, 5, 6, 7, 8, 9], 3, shuffle=True, shuffle_seed=42)
    assert a == b
    c = divide_blocks([4, 5, 6, 7, 8, 9], 3, shuffle=True, shuffle_seed=7)
    assert a != c or True  # different seed may coincide; just must not raise


def test_divide_blocks_not_enough():
    with pytest.raises(ValueError):
        divide_blocks([5], 2)


# ---------------------------------------------------------------------------
# the port against the reference, exactly
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("value", MEMORY_INPUTS, ids=str)
def test_memory_parsing_and_printing_equal_the_reference(value):
    from raydp_tpu import utils as ref

    parsed = parse_memory_size(value)
    assert parsed == ref.parse_memory_size(value)
    assert memory_string(parsed) == ref.memory_string(parsed)
    for bad in ("12XB", "", "1.2.3G"):
        with pytest.raises(ValueError):
            parse_memory_size(bad)
        with pytest.raises(ValueError):
            ref.parse_memory_size(bad)


@pytest.mark.parametrize("blocks,world_size,shuffle,seed", DIVIDE_INPUTS)
def test_divide_blocks_equals_the_reference(blocks, world_size, shuffle,
                                            seed):
    from raydp_tpu import utils as ref

    assert divide_blocks(blocks, world_size, shuffle=shuffle,
                         shuffle_seed=seed) == \
        ref.divide_blocks(blocks, world_size, shuffle=shuffle,
                          shuffle_seed=seed)


class _RouteSocket:
    """A UDP socket stand-in: ``connect`` records the address (or refuses,
    as an unroutable host does) and the socket then names a local
    address."""

    connected = []

    def __init__(self, family, kind, refuse: bool = False):
        self.family, self.kind, self.refuse = family, kind, refuse

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def connect(self, address):
        if self.refuse:
            raise OSError("Network is unreachable")
        self.connected.append(address)

    def getsockname(self):
        return ("10.1.2.3", 40000)


@pytest.mark.parametrize("refuse", [False, True], ids=["routed", "no-route"])
def test_node_address_equals_the_reference(monkeypatch, refuse):
    """The address the route lookup names, or the loopback address where
    there is no route — the reference's answer either way."""
    from raydp_tpu import utils as ref

    _RouteSocket.connected = []
    monkeypatch.setattr(socket, "socket",
                        lambda family, kind: _RouteSocket(family, kind, refuse))
    want = "127.0.0.1" if refuse else "10.1.2.3"
    assert port_utils.get_node_address() == ref.get_node_address() == want
    assert _RouteSocket.connected == ([] if refuse else [("8.8.8.8", 80)] * 2)


def test_free_port_is_bindable_on_the_host_asked():
    port = port_utils.find_free_port()
    assert 0 < port < 65536
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", port))
    assert 0 < port_utils.find_free_port("0.0.0.0") < 65536
