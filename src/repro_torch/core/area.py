"""Circuit-level area model for bit-selective TMR in DLA multiply-accumulate units.

Reproduces the paper's Section III-D / Fig. 14 analysis in gate-equivalents (GE).
All paper figures are *normalized* areas, so a relative model is sufficient; the
constants below are standard cell GE counts (NAND2 = 1 GE).

Geometry of an 8x8 multiplier (shift/array or Wallace): the partial-product
matrix has, at output column c in [0, 15], ``pp(c) = 8 - |c - 7|`` one-bit
terms for c in [0, 14] and carries only at c = 15.  Reducing a column of n
bits costs about (n - 1) compressors (full adders).

Important-bit geometry (paper Fig. 2): with an 8-bit output window [t+7 : t]
truncated out of the 24-bit accumulator, the top ``s`` output bits live at
accumulator bits [t+7-s+1 .. t+7]; the multiplier columns directly feeding
them are columns [m-s+1 .. m] with m = min(t + 7, 15).  Unconstrained, t may
be anything in [0 .. 16]; the union of important columns is then [6+ .. 15]
(for s = 2: columns 6..15, exactly the paper's example).  With the constraint
t >= Q_scale the union shrinks to [Q_scale+8-s .. 15].

Counterpart of ``repro.core.area``: a copy of its code, as the
reference's package imports JAX, which the port does not.
"""
from __future__ import annotations

import dataclasses

# gate-equivalent costs (relative; NAND2 = 1)
GE_FA = 5.0        # full adder / 3:2 compressor
GE_HA = 2.5
GE_VOTER = 4.0     # majority voter per protected output bit
GE_MUX2 = 2.5      # 2:1 mux per bit
GE_FF = 4.5        # flip-flop (pipeline reg in the PE)
GE_AND = 1.0

MUL_BITS = 8
MUL_OUT = 16
ACC_BITS = 24
OUT_BITS = 8


def pp_count(c: int, bits: int = MUL_BITS) -> int:
    """Number of partial-product bits in multiplier output column c."""
    hi = 2 * bits - 2
    if c < 0 or c > hi:
        return 0
    return bits - abs(c - (bits - 1))


def column_cost(c: int, bits: int = MUL_BITS, wallace: bool = True) -> float:
    """GE cost of the reduction logic of one output column."""
    n = pp_count(c, bits)
    if n == 0:
        return GE_FA  # carry-resolution cell at the top column
    # n:2 reduction needs ~ (n-1) FAs; array multipliers additionally ripple
    # (modelled as a small constant overhead per column).
    base = max(n - 1, 1) * GE_FA + GE_AND * n  # AND gates forming the pp bits
    if not wallace:
        base *= 1.15  # carry-save array rippling overhead
    return base


def multiplier_cost(bits: int = MUL_BITS, wallace: bool = True) -> float:
    return sum(column_cost(c, bits, wallace) for c in range(2 * bits))


def acc_cost(acc_bits: int = ACC_BITS) -> float:
    """24-bit accumulator: adder + register."""
    return acc_bits * (GE_FA + GE_FF)


def pe_cost(wallace: bool = True) -> float:
    """One unprotected PE (MAC): multiplier + accumulator."""
    return multiplier_cost(wallace=wallace) + acc_cost()


def important_columns(s: int, q_scale: int, bits: int = MUL_BITS,
                      acc_bits: int = ACC_BITS, out_bits: int = OUT_BITS):
    """Union over allowed truncations t >= q_scale of the s multiplier columns
    that directly feed the top-s output bits.  Returns (lo, hi) inclusive."""
    if s <= 0:
        return (0, -1)
    mul_out = 2 * bits
    t_lo = max(q_scale, 0)
    t_hi = acc_bits - out_bits
    m_lo = min(t_lo + out_bits - 1, mul_out - 1)
    lo = max(m_lo - s + 1, 0)
    hi = mul_out - 1  # for large t the window slides past the product top
    if t_hi + out_bits - 1 < mul_out - 1:
        hi = t_hi + out_bits - 1
    return (lo, hi)


def important_acc_bits(s: int, q_scale: int, acc_bits: int = ACC_BITS,
                       out_bits: int = OUT_BITS) -> int:
    """Number of accumulator bit positions that can be important."""
    if s <= 0:
        return 0
    t_lo = max(q_scale, 0)
    t_hi = acc_bits - out_bits
    lo = t_lo + out_bits - s
    hi = min(t_hi + out_bits - 1, acc_bits - 1)
    return max(hi - lo + 1, 0)


@dataclasses.dataclass(frozen=True)
class BitProtectCost:
    """Breakdown of the redundant area of one protected PE (in GE)."""
    mult_redundant: float
    acc_redundant: float
    voters: float
    mux: float

    @property
    def total(self) -> float:
        return self.mult_redundant + self.acc_redundant + self.voters + self.mux


def bit_protect_cost(s: int, q_scale: int = 0, policy: str = "direct",
                     wallace: bool = True) -> BitProtectCost:
    """Extra area to TMR-protect the top-s output bits of one PE.

    policy:
      "direct"       — triplicate every column that can ever be important.
      "configurable" — provide redundant units sized to the largest s columns,
        MUX-steered to the active window; left columns merged to cut fan-out
        (paper Fig. 4).
    """
    if s <= 0:
        return BitProtectCost(0.0, 0.0, 0.0, 0.0)
    lo, hi = important_columns(s, q_scale)
    cols = list(range(lo, hi + 1))
    col_costs = [column_cost(c, wallace=wallace) for c in cols]

    n_acc = important_acc_bits(s, q_scale)
    acc_red = 2.0 * n_acc * GE_FA           # two extra adder slices per bit
    voters = GE_VOTER * (s + n_acc)         # vote the s product bits + acc bits

    if policy == "direct":
        mult_red = 2.0 * sum(col_costs)     # two extra copies of each column
        mux = 0.0
    elif policy == "configurable":
        # redundant capacity = 2 copies of the s largest columns in the region
        largest = sorted(col_costs, reverse=True)[:s]
        mult_red = 2.0 * sum(largest)
        # MUX steering: each redundant FA input selects among the candidate
        # columns; merging adjacent small (left) columns reduces the effective
        # fan-out from len(cols) to ~ceil(len(cols)/2) + s
        fanout = max(len(cols) - s, 0)
        merged_fanout = (fanout + 1) // 2
        n_red_bits = sum(pp_count(c) for c in cols[-s:])
        mux = GE_MUX2 * n_red_bits * max(merged_fanout, 1) * 0.5
    else:
        raise ValueError(f"unknown PE policy {policy!r}")
    return BitProtectCost(mult_red, acc_red, voters, mux)


def protected_pe_cost(s: int, q_scale: int = 0, policy: str = "direct",
                      wallace: bool = True) -> float:
    return pe_cost(wallace) + bit_protect_cost(s, q_scale, policy, wallace).total


def full_tmr_pe_cost(wallace: bool = True) -> float:
    """Classic TMR: triplicate the whole PE + voters on every output bit."""
    return 3.0 * pe_cost(wallace) + GE_VOTER * ACC_BITS


def array_area(array_dim: int, nb_th: int, q_scale: int, pe_policy: str,
               dot_size: int = 0, ib_th: int = 0, wallace: bool = True) -> dict:
    """FlexHyCA computing-array area (GE): 2D array with NB_TH-bit protection
    + DPPU (dot_size MACs) with IB_TH-bit protection.  Returns a breakdown and
    the ratio to an unprotected 2D array (the paper's normalization)."""
    base = array_dim * array_dim * pe_cost(wallace)
    arr = array_dim * array_dim * protected_pe_cost(nb_th, q_scale, pe_policy, wallace)
    dppu = dot_size * protected_pe_cost(ib_th, q_scale, pe_policy, wallace)
    # DPPU adder tree + control + importance-table SRAM interface (small)
    dppu_ctrl = dot_size * GE_FA * 2 + 64 * GE_FF
    total = arr + dppu + dppu_ctrl
    return dict(base=base, array=arr, dppu=dppu + dppu_ctrl, total=total,
                relative=total / base, overhead=(total - base) / base)
