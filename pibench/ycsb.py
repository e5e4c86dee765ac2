"""YCSB traffic, made from a seed on the device it runs on.

The benchmark's own generator: the program under test receives only what
this module makes.  It follows YCSB's core workloads
(https://github.com/brianfrankcooper/YCSB, ``core/src/main/java/site/
ycsb/generator``):

* **Keys.**  Record ``i`` has the key ``KeyMap(seed)(i)``, a bijection
  of ``[0, key_space)`` (YCSB's ``insertorder=hashed``), so the N loaded
  records are N distinct keys spread over the key space, and the j-th
  inserted record, ``N + j``, has a key no loaded record has.
* **Skew.**  ``Zipfian`` is Gray et al.'s generator as YCSB's
  ``ZipfianGenerator`` computes it, with zeta(N, theta) over all N records;
  ``scrambled_zipfian`` hashes its rank with YCSB's 64-bit FNV, as
  ``ScrambledZipfianGenerator`` does, so the hot records lie all over the
  key space.  The hottest record takes 1/zeta(N, theta) of the draws.
* **Values.**  A record's value is its record id (the index maps a key to
  where its record lives).  An update writes the record anew: its value
  becomes ``records + op index``, so every acknowledged write leaves a
  value no earlier state held.
* **Scans.**  A scan of L records starts at a record's key and spans
  ``L * key_space // records`` key units, YCSB-E's lengths counted in
  records at the data set's density.

Op codes are the index's: SEARCH 0, INSERT 1, DELETE 2, RANGE 3 (the
harness checks them against the program's).
"""
from __future__ import annotations

import numpy as np
import torch

SEARCH, INSERT, DELETE, RANGE = 0, 1, 2, 3

# YCSB's Utils.FNVhash64 constants (as signed 64-bit words)
FNV_OFFSET_BASIS_64 = 0xCBF29CE484222325 - (1 << 64)
FNV_PRIME_64 = 1099511628211

# ops a device call makes at a time, to keep set-up's memory small
CHUNK = 1 << 24


class KeyMap:
    """A seeded bijection of ``[0, key_space)``: three rounds of an odd
    multiply, an xor-shift by half the bits and an add, each a bijection
    modulo a power of two."""

    def __init__(self, seed: int, key_space: int):
        bits = key_space.bit_length() - 1
        if key_space != 1 << bits or bits < 4 or bits > 30:
            raise ValueError(f"key_space {key_space} must be a power of two "
                             f"between 2^4 and 2^30 (below the int32 "
                             f"sentinel)")
        rng = np.random.default_rng([seed, 0x6B6579])
        self.mask = key_space - 1
        self.shift = bits // 2
        self.mult = [int(m) | 1 for m in rng.integers(1, key_space, 3)]
        self.add = [int(a) for a in rng.integers(0, key_space, 3)]

    def __call__(self, ids: torch.Tensor) -> torch.Tensor:
        x = ids.to(torch.int64)
        for m, a in zip(self.mult, self.add):
            x = (x * m) & self.mask
            x = x ^ (x >> self.shift)
            x = (x + a) & self.mask
        return x


def zeta(n: int, theta: float) -> float:
    """sum_{i=1}^{n} i^-theta: exact up to 2^20 terms, the rest by the
    Euler-Maclaurin formula (error below 1e-15 of the sum)."""
    m = min(n, 1 << 20)
    head = float(np.sum(np.arange(1, m + 1, dtype=np.float64) ** -theta))
    if n == m:
        return head

    def f(x):
        return x ** -theta

    def df(x):
        return -theta * x ** (-theta - 1)

    integral = (n ** (1 - theta) - m ** (1 - theta)) / (1 - theta)
    return head + integral + (f(n) - f(m)) / 2 + (df(n) - df(m)) / 12


class Zipfian:
    """Gray et al.'s zipfian over ranks ``[0, n)`` (YCSB's
    ``ZipfianGenerator.nextLong``): rank 0 takes 1/zeta(n, theta)."""

    def __init__(self, n: int, theta: float):
        if not 0 < theta < 1 or n < 2:
            raise ValueError(f"zipfian needs 0 < theta < 1 and n >= 2, got "
                             f"theta={theta}, n={n}")
        self.n, self.theta = n, theta
        self.zetan = zeta(n, theta)
        self.alpha = 1.0 / (1.0 - theta)
        self.eta = (1 - (2.0 / n) ** (1 - theta)) / \
            (1 - zeta(2, theta) / self.zetan)

    def ranks(self, u: torch.Tensor) -> torch.Tensor:
        """Ranks of float64 uniforms ``u`` in [0, 1)."""
        uz = u * self.zetan
        tail = (self.n * (self.eta * u - self.eta + 1) ** self.alpha).long()
        r = torch.where(uz < 1.0 + 0.5 ** self.theta, 1, tail)
        r = torch.where(uz < 1.0, 0, r)
        return r.clamp(0, self.n - 1)


def fnv64(x: torch.Tensor) -> torch.Tensor:
    """YCSB's ``Utils.FNVhash64`` of int64 values (wrapping arithmetic,
    ``Math.abs`` of the hash)."""
    h = torch.full_like(x, FNV_OFFSET_BASIS_64)
    v = x.clone()
    for _ in range(8):
        h = (h ^ (v & 0xFF)) * FNV_PRIME_64
        v = v >> 8
    return h.abs()


def scrambled_zipfian(zipf: Zipfian, u: torch.Tensor) -> torch.Tensor:
    """Record ids in ``[0, zipf.n)``: FNV-hashed zipfian ranks."""
    return torch.remainder(fnv64(zipf.ranks(u)), zipf.n)


def key_units_per_record(config: dict) -> int:
    return config["key_space"] // config["records"]


def check_traffic(traffic: dict, config: dict):
    """Refuse a mix this generator or the reference cannot serve exactly."""
    mix = traffic["mix"]
    unknown = set(mix) - {"read", "update", "insert", "scan"}
    if unknown:
        raise ValueError(f"unknown op classes {sorted(unknown)}")
    if abs(sum(mix.values()) - 1.0) > 1e-9:
        raise ValueError(f"op shares {mix} do not add up to 1")
    if traffic["request_distribution"] not in ("zipfian", "uniform"):
        raise ValueError(f"request_distribution "
                         f"{traffic['request_distribution']!r}")
    if mix.get("scan", 0):
        span = traffic["max_scan_length"] * key_units_per_record(config)
        # a span of at most max_span keys holds at most max_span keys, so
        # the index's occupied-key budget never truncates a scan
        if span > config["max_span"]:
            raise ValueError(f"scans span up to {span} keys, over the "
                             f"index's max_span {config['max_span']}")


def make_ops(traffic: dict, config: dict, seed: int, count: int,
             device) -> dict:
    """``count`` ops of the mix, in issue order: int32 tensors ``ops``,
    ``keys``, ``keys2`` (a scan's inclusive upper bound, else 0) and
    ``vals`` on ``device``.  Made in chunks of ``CHUNK`` ops by one
    generator on ``device`` seeded from ``seed``."""
    check_traffic(traffic, config)
    n = config["records"]
    keymap = KeyMap(seed, config["key_space"])
    zipf = Zipfian(n, traffic["zipfian_constant"]) \
        if traffic["request_distribution"] == "zipfian" else None
    mix = traffic["mix"]
    # op classes in order: read, update, insert (-1: a new record), scan
    classes = [(SEARCH, mix.get("read", 0.0)),
               (INSERT, mix.get("update", 0.0)),
               (-1, mix.get("insert", 0.0)), (RANGE, mix.get("scan", 0.0))]
    cuts = torch.tensor(np.cumsum([p for _, p in classes])[:-1],
                        dtype=torch.float64, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    unit = key_units_per_record(config)
    out = {k: [] for k in ("ops", "keys", "keys2", "vals")}
    inserted = 0
    for start in range(0, count, CHUNK):
        m = min(CHUNK, count - start)
        cls = torch.bucketize(
            torch.rand(m, dtype=torch.float64, generator=gen, device=device),
            cuts, right=True)
        u = torch.rand(m, dtype=torch.float64, generator=gen, device=device)
        rec = scrambled_zipfian(zipf, u) if zipf is not None else \
            (u * n).long().clamp_max(n - 1)
        is_ins = cls == 2
        new_rec = n + inserted + torch.cumsum(is_ins, 0) - 1
        inserted += int(is_ins.sum())
        rec = torch.where(is_ins, new_rec, rec)
        key = keymap(rec)
        idx = start + torch.arange(m, device=device)
        code = torch.tensor([c if c >= 0 else INSERT for c, _ in classes],
                            dtype=torch.int32, device=device)[cls]
        is_upd = cls == 1
        is_scan = code == RANGE
        length = torch.randint(1, traffic.get("max_scan_length", 1) + 1, (m,),
                               generator=gen, device=device)
        val = torch.where(is_upd, n + idx, torch.where(is_ins, rec, 0))
        out["ops"].append(code)
        out["keys"].append(key.to(torch.int32))
        # a scan past the last key reads to the end of the key space
        hi = (key + length * unit - 1).clamp_max(config["key_space"] - 1)
        out["keys2"].append(torch.where(is_scan, hi, 0).to(torch.int32))
        out["vals"].append(val.to(torch.int32))
    if n + inserted > config["key_space"] or n + count >= 1 << 31:
        raise ValueError("the mix inserts past the key space, or its values "
                         "pass int32")
    return {k: torch.cat(v) for k, v in out.items()}


def base_records(config: dict, seed: int, device):
    """The loaded records: ``(keys, vals)`` int32 tensors on ``device``,
    record i holding key ``KeyMap(seed)(i)`` and value i."""
    n = config["records"]
    ids = torch.arange(n, device=device)
    return KeyMap(seed, config["key_space"])(ids).to(torch.int32), \
        ids.to(torch.int32)

