"""Savings-ratio analytics (paper §5.3, Eq. 4–6) and break-even points.

The port's own copy of ``repro.core.savings`` (pure Python, no tensors),
kept identical so both packages reconcile a run the same way.

SR = (OriginalSize * CommRounds * Collabs)
     / (CompressedSize * CommRounds * Collabs + Cost),          (Eq. 4)
Cost = DecoderSize * NumDecoders = (AutoencoderSize / 2) * NumDecoders.
                                                              (Eq. 5/6)
Sizes are in parameter counts (the paper's unit); bytes scale both sides
equally so the ratio is unit-free.

:func:`reconcile` closes the loop with the runtime (DESIGN.md §8.3): the
schedulers now *observe* every term of Eq. 4–6 — compressed/raw uplink per
round, and one decoder sync per ``ae_syncs`` entry — so the analytic model
can be cross-checked against what a run actually shipped.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Union


@dataclasses.dataclass(frozen=True)
class SavingsModel:
    original_size: int          # collaborator update size (params)
    compressed_size: int        # latent size (params)
    autoencoder_size: int       # total AE params (decoder = half)
    n_decoders: int = 1         # 1 = shared decoder (case a); C = per-collab

    def __post_init__(self):
        # bugfix guard: negative sizes turned Eq. 4's denominator negative
        # and the break-even bisections below returned meaningless
        # (negative-ratio-driven) answers — reject them at construction
        if (self.original_size < 0 or self.compressed_size < 0
                or self.autoencoder_size < 0 or self.n_decoders < 0):
            raise ValueError(
                "SavingsModel sizes/counts must be non-negative, got "
                f"original={self.original_size} "
                f"compressed={self.compressed_size} "
                f"autoencoder={self.autoencoder_size} "
                f"n_decoders={self.n_decoders}")

    @property
    def decoder_size(self) -> float:
        return self.autoencoder_size / 2.0                       # Eq. 6

    @property
    def cost(self) -> float:
        return self.decoder_size * self.n_decoders               # Eq. 5

    def savings_ratio(self, comm_rounds: int, collabs: int) -> float:
        """Eq. 4. A degenerate zero denominator — ``compressed_size == 0``
        (or zero rounds/collabs) with a zero-cost decoder — reads as free
        communication: ``inf``, not a ZeroDivisionError."""
        num = self.original_size * comm_rounds * collabs          # Eq. 4
        den = self.compressed_size * comm_rounds * collabs + self.cost
        if den == 0:
            return float("inf")
        return num / den

    def break_even_collabs(self, comm_rounds: int,
                           max_collabs: int = 10 ** 7) -> Optional[int]:
        """Smallest collaborator count with SR > 1 (Fig. 10 break-even).
        ``None`` is the documented no-break-even sentinel: a scheme whose
        compression ratio is ≤ 1 never pays for its decoder however many
        collaborators join (SR is bounded by ``asymptotic_ratio``), so the
        bisection is skipped rather than probing 10^7 collaborators of a
        ratio that cannot cross 1."""
        if self.asymptotic_ratio() <= 1.0:
            return None
        lo, hi = 1, max_collabs
        if self.savings_ratio(comm_rounds, hi) <= 1.0:
            return None
        while lo < hi:
            mid = (lo + hi) // 2
            if self.savings_ratio(comm_rounds, mid) > 1.0:
                hi = mid
            else:
                lo = mid + 1
        return lo

    def break_even_rounds(self, collabs: int,
                          max_rounds: int = 10 ** 7) -> Optional[int]:
        """Smallest round count with SR > 1 (Fig. 11 break-even); ``None``
        = never breaks even (see :meth:`break_even_collabs`)."""
        if self.asymptotic_ratio() <= 1.0:
            return None
        lo, hi = 1, max_rounds
        if self.savings_ratio(hi, collabs) <= 1.0:
            return None
        while lo < hi:
            mid = (lo + hi) // 2
            if self.savings_ratio(mid, collabs) > 1.0:
                hi = mid
            else:
                lo = mid + 1
        return lo

    def asymptotic_ratio(self) -> float:
        """SR as rounds*collabs → ∞ = raw compression ratio (``inf`` for a
        zero-width latent — the degenerate everything-is-free codec)."""
        if self.compressed_size == 0:
            return float("inf")
        return self.original_size / self.compressed_size


def sweep_collaborators(model: SavingsModel, comm_rounds: int,
                        collabs: List[int]) -> List[float]:
    return [model.savings_ratio(comm_rounds, c) for c in collabs]


def sweep_rounds(model: SavingsModel, collabs: int,
                 rounds: List[int]) -> List[float]:
    return [model.savings_ratio(r, collabs) for r in rounds]


def reconcile(model: Union[SavingsModel, Mapping[str, SavingsModel]],
              records: Sequence,
              *, bytes_per_param: float = 4.0) -> Dict[str, float]:
    """Reconcile a run's observed accounting with Eq. 4–6 (DESIGN.md §8.3).

    ``records`` is the run's ``RoundRecord`` history. Observed quantities
    come straight from the scheduler layer: uplink bytes (compressed and
    raw) and the decoder-sync bytes the AE lifecycle charged. Predictions
    restate Eq. 4–6 in observed-byte units — predicted decoder cost is
    ``DecoderSize × observed sync count`` (Eq. 5 with NumDecoders = the
    syncs that actually happened; under refreshes a decoder ships more than
    once, which Fig. 10/11's static Cost term underestimates), and the
    predicted savings ratio divides raw traffic by (raw / asymptotic-ratio
    + predicted cost), i.e. Eq. 4 with the model's CompressedSize.

    Under per-layer codec partitions (DESIGN.md §10.4) ``model`` is a
    ``{group_name: SavingsModel}`` mapping: each partition owns its own
    decoder size and compression ratio, so the predicted Cost term sums
    **per-partition decoder ships** — ``ae_syncs`` entries are
    ``(client, group)`` pairs, counted against their own group's
    DecoderSize — and predicted uplink apportions the observed raw bytes
    by each group's OriginalSize share before dividing by that group's
    ratio (exact whenever every participant ships every group, which every
    scheduler does). A single-unit wire model under partitioning would
    mis-price mixed ladders; this keeps the documented ≲1% structural gap.

    The small ``decoder_rel_err`` that remains is structural, not a bug:
    Eq. 6 idealizes DecoderSize as AutoencoderSize/2, while a funnel AE's
    decoder half differs from half by the bias asymmetry (output-width
    biases vs latent-width biases) plus the 2-scalar normalizer the wire
    format ships (``autoencoder.decoder_tree``)."""
    up = float(sum(r.bytes_up for r in records))
    up_raw = float(sum(r.bytes_up_raw for r in records))
    dec_bytes = float(sum(getattr(r, "bytes_decoder", 0.0) for r in records))
    sync_list = [s for r in records
                 for s in (getattr(r, "ae_syncs", None) or [])]
    syncs = len(sync_list)
    if isinstance(model, Mapping):
        syncs_by_group: Dict[str, int] = {name: 0 for name in model}
        for s in sync_list:
            assert isinstance(s, (tuple, list)) and len(s) == 2, (
                f"per-partition reconcile needs (client, group) sync "
                f"entries, got {s!r} — pass a single SavingsModel for "
                "flat runs")
            syncs_by_group[s[1]] += 1
        predicted_dec = sum(m.decoder_size * syncs_by_group[name]
                            * bytes_per_param for name, m in model.items())
        total_orig = float(sum(m.original_size for m in model.values()))
        predicted_up = sum(
            (up_raw * m.original_size / total_orig) / m.asymptotic_ratio()
            for m in model.values())
    else:
        assert not any(isinstance(s, (tuple, list)) for s in sync_list), (
            "partitioned run history ((client, group) sync entries) needs "
            "a {group: SavingsModel} mapping — a single model would count "
            "every per-group ship as a full-model decoder")
        predicted_dec = model.decoder_size * syncs * bytes_per_param
        predicted_up = up_raw / model.asymptotic_ratio()
    observed_sr = up_raw / (up + dec_bytes) if up + dec_bytes else float("inf")
    predicted_sr = (up_raw / (predicted_up + predicted_dec)
                    if predicted_up + predicted_dec else float("inf"))

    def rel(observed: float, predicted: float) -> float:
        return abs(observed - predicted) / max(abs(predicted), 1e-12)

    return {
        "rounds": float(len(records)),
        "decoder_syncs": float(syncs),
        "observed_decoder_bytes": dec_bytes,
        "predicted_decoder_bytes": predicted_dec,
        "decoder_rel_err": rel(dec_bytes, predicted_dec) if syncs else 0.0,
        "observed_savings_ratio": observed_sr,
        "predicted_savings_ratio": predicted_sr,
        "savings_rel_err": rel(observed_sr, predicted_sr),
    }
