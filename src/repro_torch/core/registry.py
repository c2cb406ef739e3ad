"""The declarative measure registry: one table drives every consumer.

Every measure the framework understands is a :class:`MeasureSpec` row in
:data:`REGISTRY`, declaring

* its **trec_eval spelling** (the ``family`` id and output-key format:
  ``map``, ``ndcg_cut_10``, ``iprec_at_recall_0.10``, ``rbp_0.80``),
* its **ir-measures spelling(s)** (``AP``, ``nDCG@10``, ``IPrec@0.10``,
  ``RBP(p=0.8)``) including accepted aliases,
* its **parameterization** (integer cutoffs, recall levels, the RBP
  persistence ``p``, and the global ``rel=`` relevance level),
* its **per-query column function** over ``measures.SortedBatch``
  (resolved lazily by attribute name, so this module stays import-clean),
* its **aggregation kind** (arithmetic mean, sum, or geometric
  aggregate-only), integer formatting, the contribution a query missing
  from the run makes under trec_eval ``-c``, and
* its **ranking-depth bound** — whether the column only reads a bounded
  prefix of the ranking (``P@k`` et al.), which lets the evaluator route
  the batch through the top-k kernel instead of a full document sort.

Everything else derives from this table: ``parse_measures`` /
``measure_keys`` in :mod:`repro_torch.core.measures` and the CLI's print
order and int/sum/aggregate-only sets.  This is the PyTorch port's own copy
of ``repro.core.registry`` (importing that module would pull in JAX); the
two tables must stay identical, which ``tests/test_torch_spec.py`` checks.
Adding a measure is one row here and one column function in
``measures.py``.

Both dialects parse to the same canonical keys:

>>> canonicalize(("nDCG@10", "map"))[0]
(('map', ()), ('ndcg_cut', (10.0,)))
>>> canonicalize(("AP(rel=2)",))
((('map', ()),), 2.0)
>>> render_ir("ndcg_cut_10"), render_ir("rbp_0.80"), render_ir("map")
('nDCG@10', 'RBP(p=0.8)', 'AP')
>>> render_trec("nDCG@10")
'ndcg_cut_10'
"""

from __future__ import annotations

import re
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

# -- shared measure constants (single source of truth; ``measures`` re-exports)

DEFAULT_CUTOFFS: Tuple[int, ...] = (5, 10, 15, 20, 30, 100, 200, 500, 1000)
SUCCESS_CUTOFFS: Tuple[int, ...] = (1, 5, 10)
IPREC_LEVELS: Tuple[float, ...] = tuple(round(0.1 * i, 1) for i in range(11))

#: trec_eval's MIN_GEO_MEAN: per-query AP is clipped to this before the log
#: so queries with AP == 0 do not collapse the geometric mean to 0.
GM_MIN: float = 1e-5

#: default RBP persistence (Moffat & Zobel's common choice)
DEFAULT_RBP_P: float = 0.8


class MeasureError(ValueError):
    """A measure string failed to parse/resolve."""


class MeasureSpec(NamedTuple):
    """One measure family: both spellings, parameterization, and behavior."""

    family: str                 # canonical trec_eval family id / key stem
    ir_name: str                # canonical ir-measures spelling
    column: str                 # column fn name in repro_torch.core.measures
    description: str            # one-liner
    ir_aliases: Tuple[str, ...] = ()   # extra accepted ir spellings
    param_kind: str = ""        # "" | "cutoff" | "level" | "p"
    default_params: Tuple[float, ...] = ()
    agg: str = "mean"           # "mean" | "sum" | "geometric"
    integer: bool = False       # CLI prints as integer (trec_eval %ld)
    aggregate_only: bool = False  # summary-only (no per-query lines)
    missing: str = "zero"       # -c contribution: "zero"|"n_rel"|"log_gm_min"
    depth: str = "full"         # "full" | "param" | "none" (ranking prefix)
    cut_family: Optional[str] = None   # ir "@k" redirects to this family


#: Declaration order IS the trec_eval print order (``cli.FAMILY_ORDER``).
REGISTRY: Tuple[MeasureSpec, ...] = (
    MeasureSpec("num_ret", "NumRet", "num_ret",
                "retrieved documents", agg="sum", integer=True, depth="none"),
    MeasureSpec("num_rel", "NumRel", "num_rel",
                "relevant documents in the qrels (R)", agg="sum",
                integer=True, missing="n_rel", depth="none"),
    MeasureSpec("num_rel_ret", "NumRelRet", "num_rel_ret",
                "relevant retrieved documents", agg="sum", integer=True),
    MeasureSpec("map", "AP", "average_precision",
                "mean average precision", ir_aliases=("MAP",),
                cut_family="map_cut"),
    MeasureSpec("gm_map", "GMAP", "gm_map_contrib",
                "geometric-mean MAP (AP clipped at GM_MIN)",
                agg="geometric", aggregate_only=True, missing="log_gm_min"),
    MeasureSpec("Rprec", "Rprec", "r_precision",
                "precision at rank R"),
    MeasureSpec("bpref", "Bpref", "bpref",
                "judged-only preference measure"),
    MeasureSpec("recip_rank", "RR", "reciprocal_rank",
                "reciprocal rank of the first relevant document",
                ir_aliases=("MRR",)),
    MeasureSpec("iprec_at_recall", "IPrec", "iprec_at_recall",
                "interpolated precision at a recall level (11-pt PR curve)",
                param_kind="level", default_params=IPREC_LEVELS),
    MeasureSpec("P", "P", "precision_at",
                "precision at rank k (always divided by k)",
                param_kind="cutoff",
                default_params=tuple(map(float, DEFAULT_CUTOFFS)),
                depth="param"),
    MeasureSpec("recall", "R", "recall_at",
                "recall at rank k", ir_aliases=("Recall",),
                param_kind="cutoff",
                default_params=tuple(map(float, DEFAULT_CUTOFFS)),
                depth="param"),
    MeasureSpec("ndcg", "nDCG", "ndcg",
                "normalized DCG over the full ranking (linear gain)",
                cut_family="ndcg_cut"),
    MeasureSpec("ndcg_cut", "nDCG", "ndcg_cut",
                "normalized DCG at rank k", param_kind="cutoff",
                default_params=tuple(map(float, DEFAULT_CUTOFFS)),
                depth="param"),
    MeasureSpec("map_cut", "AP", "map_cut",
                "average precision at rank k", param_kind="cutoff",
                default_params=tuple(map(float, DEFAULT_CUTOFFS)),
                depth="param"),
    MeasureSpec("success", "Success", "success_at",
                "1 iff a relevant document appears in the top k",
                param_kind="cutoff",
                default_params=tuple(map(float, SUCCESS_CUTOFFS)),
                depth="param"),
    MeasureSpec("judged", "Judged", "judged_at",
                "fraction of the top k that is judged", param_kind="cutoff",
                default_params=tuple(map(float, DEFAULT_CUTOFFS)),
                depth="param"),
    MeasureSpec("rbp", "RBP", "rbp",
                "rank-biased precision with persistence p",
                param_kind="p", default_params=(DEFAULT_RBP_P,)),
    MeasureSpec("err", "ERR", "err_at",
                "expected reciprocal rank at k (cascade model, per-query "
                "max grade)", param_kind="cutoff",
                default_params=tuple(map(float, DEFAULT_CUTOFFS)),
                depth="param"),
)

SPECS: Dict[str, MeasureSpec] = {spec.family: spec for spec in REGISTRY}

#: case-insensitive ir-measures name lookup; declaration order wins, so
#: ``AP``/``nDCG`` resolve to the full-depth family (whose ``cut_family``
#: redirects ``AP@k``/``nDCG@k`` to the corresponding ``*_cut`` family).
_IR_LOOKUP: Dict[str, MeasureSpec] = {}
for _spec in REGISTRY:
    for _nm in (_spec.ir_name,) + _spec.ir_aliases:
        _IR_LOOKUP.setdefault(_nm.lower(), _spec)
del _spec, _nm

Parsed = Tuple[Tuple[str, Tuple[float, ...]], ...]

_IR_RE = re.compile(
    r"^\s*([A-Za-z][A-Za-z_]*)\s*(?:\((.*)\))?\s*(?:@(\d+(?:\.\d+)?))?\s*$")


# -- derivations -------------------------------------------------------------


def supported_families() -> frozenset:
    """Every family id (the old ``SUPPORTED_MEASURES`` frozenset, derived)."""
    return frozenset(SPECS)


def aggregate_only_families() -> frozenset:
    return frozenset(s.family for s in REGISTRY if s.aggregate_only)


def family_order() -> Tuple[str, ...]:
    """trec_eval print order == registry declaration order."""
    return tuple(s.family for s in REGISTRY)


def integer_keys() -> frozenset:
    """Keys the CLI prints as integers (all are paramless families)."""
    return frozenset(s.family for s in REGISTRY if s.integer)


def sum_families() -> frozenset:
    """Families summarized by summation rather than the mean over queries."""
    return frozenset(s.family for s in REGISTRY if s.agg == "sum")


# -- parameter / key plumbing ------------------------------------------------


def _check_param(fam: str, kind: str, value: float, origin: str) -> float:
    if kind == "cutoff":
        if value < 1 or value != int(value):
            raise MeasureError(
                f"measure {origin!r}: cutoff must be a positive integer, "
                f"got {value:g}")
    elif kind == "level":
        if not 0.0 <= value <= 1.0:
            raise MeasureError(
                f"measure {origin!r}: recall level must be in [0, 1], "
                f"got {value:g}")
    elif kind == "p":
        if not 0.0 < value < 1.0 or round(value, 2) != value:
            raise MeasureError(
                f"measure {origin!r}: persistence p must be in (0, 1) with "
                f"at most two decimals, got {value:g}")
    return float(value)


def family_keys(fam: str, params: Tuple[float, ...]) -> Tuple[str, ...]:
    """Output keys for one parsed (family, params) entry.

    Owns the pytrec_eval key-format rules: float-parameterized families
    (``iprec_at_recall``, ``rbp``) print the parameter with two decimals,
    cutoffs as integers, paramless families are their own key.
    """
    if not params:
        return (fam,)
    if SPECS[fam].param_kind in ("level", "p"):
        return tuple(f"{fam}_{p:.2f}" for p in params)
    return tuple(f"{fam}_{int(p)}" for p in params)


def split_key(key: str) -> Tuple[str, Optional[float]]:
    """Canonical output key → (family, parameter).

    >>> split_key("ndcg_cut_10"), split_key("map"), split_key("rbp_0.80")
    (('ndcg_cut', 10.0), ('map', None), ('rbp', 0.8))
    """
    spec = SPECS.get(key)
    if spec is not None and not spec.param_kind:
        return key, None
    for fam, s in SPECS.items():
        if s.param_kind and key.startswith(fam + "_"):
            try:
                value = float(key[len(fam) + 1:])
            except ValueError:
                continue
            return fam, _check_param(fam, s.param_kind, value, key)
    raise MeasureError(f"unsupported measure: {key!r}")


def _parse_trec(m: str):
    """trec_eval-dialect parse: (family, params|None) or None if not trec."""
    spec = SPECS.get(m)
    if spec is not None:
        return m, None
    for fam, s in SPECS.items():
        if s.param_kind and m.startswith(fam + "_"):
            try:
                value = float(m[len(fam) + 1:])
            except ValueError:
                return None
            return fam, (_check_param(fam, s.param_kind, value, m),)
    if "." in m:
        fam, _, arg = m.partition(".")
        s = SPECS.get(fam)
        if s is None or not s.param_kind:
            return None
        try:
            values = tuple(float(x) for x in arg.split(","))
        except ValueError:
            return None
        return fam, tuple(_check_param(fam, s.param_kind, v, m)
                          for v in values)
    return None


def _parse_ir(m: str):
    """ir-measures-dialect parse: (family, params|None, rel|None) or None."""
    mt = _IR_RE.match(m)
    if mt is None:
        return None
    name, argstr, at = mt.groups()
    spec = _IR_LOOKUP.get(name.lower())
    if spec is None:
        return None
    rel = None
    p = None
    if argstr is not None and argstr.strip():
        for part in argstr.split(","):
            key, eq, value = part.partition("=")
            key = key.strip()
            try:
                fv = float(value.strip()) if eq else None
            except ValueError:
                fv = None
            if fv is None:
                raise MeasureError(
                    f"measure {m!r}: malformed argument {part.strip()!r} "
                    f"(expected name=number)")
            if key == "rel":
                rel = fv
            elif key == "p" and spec.param_kind == "p":
                p = _check_param(spec.family, "p", fv, m)
            else:
                raise MeasureError(
                    f"measure {m!r}: unknown argument {key!r} for "
                    f"{spec.ir_name}")
    if at is not None:
        if spec.cut_family:
            spec = SPECS[spec.cut_family]
        if spec.param_kind not in ("cutoff", "level"):
            raise MeasureError(
                f"measure {m!r}: {spec.ir_name} does not take an @cutoff")
        params = (_check_param(spec.family, spec.param_kind, float(at), m),)
    elif p is not None:
        params = (p,)
    else:
        params = None
    return spec.family, params, rel


def parse_single(m: str):
    """One measure string (either dialect) → (family, params|None, rel|None).

    The trec_eval dialect is tried first (it is the canonical key space),
    the ir-measures dialect second; anything else raises
    :class:`MeasureError` naming the offending string.
    """
    trec = _parse_trec(m)
    if trec is not None:
        return trec[0], trec[1], None
    ir = _parse_ir(m)
    if ir is not None:
        return ir
    raise MeasureError(f"unsupported measure: {m!r}")


def canonicalize(measures: Sequence[str],
                 relevance_level: Optional[float] = None,
                 ) -> Tuple[Parsed, float]:
    """Measure strings in either dialect → (parsed selectors, level).

    The parsed form is the hashable ``((family, params), ...)`` tuple the
    jitted measure core takes as a static argument: families sorted by
    name, repeated same-family selectors merged with the union of their
    params (the repeatable ``-m`` contract).

    ``rel=`` annotations resolve the relevance level: all occurrences must
    agree, and an explicit non-default ``relevance_level`` (or ``-l``) must
    not contradict them.

    >>> canonicalize(("P@5", "P_10", "AP"))
    ((('P', (5.0, 10.0)), ('map', ())), 1.0)
    >>> canonicalize(("P(rel=2)@5",), relevance_level=3)
    Traceback (most recent call last):
        ...
    repro_torch.core.registry.MeasureError: rel=2 conflicts with relevance_level=3
    """
    rels = {}
    merged: Dict[str, Tuple[float, ...]] = {}
    for m in sorted(set(str(x) for x in measures)):
        fam, params, rel = parse_single(m)
        if rel is not None:
            rels[m] = rel
        if params is None:
            params = SPECS[fam].default_params
        merged[fam] = tuple(sorted(set(merged.get(fam, ()) + params)))
    levels = sorted(set(rels.values()))
    if len(levels) > 1:
        raise MeasureError(
            "conflicting rel= levels across measures: "
            + ", ".join(f"{m} (rel={r:g})" for m, r in sorted(rels.items())))
    if levels:
        level = levels[0]
        if relevance_level is not None and float(relevance_level) != level \
                and float(relevance_level) != 1.0:
            raise MeasureError(
                f"rel={level:g} conflicts with "
                f"relevance_level={float(relevance_level):g}")
    else:
        level = float(relevance_level) if relevance_level is not None else 1.0
    return tuple(sorted(merged.items())), level


def parse_measures(measures: Sequence[str]) -> Parsed:
    """Level-agnostic canonicalization (the classic ``parse_measures``).

    Raises if a ``rel=`` annotation asks for a non-default relevance level —
    callers that support it (the evaluator, the CLI)
    use :func:`canonicalize` and thread the level explicitly.
    """
    parsed, level = canonicalize(measures)
    if level != 1.0:
        raise MeasureError(
            f"rel={level:g} requires a relevance_level-aware caller "
            f"(pass relevance_level / -l instead)")
    return parsed


def measure_keys(measures: Sequence[str]) -> Tuple[str, ...]:
    """The pytrec_eval-style output keys produced for a measure set."""
    keys = []
    for fam, params in parse_measures(measures):
        keys.extend(family_keys(fam, params))
    return tuple(keys)


def keys_for(parsed: Parsed) -> Tuple[str, ...]:
    """Output keys for an already-parsed selector tuple."""
    keys = []
    for fam, params in parsed:
        keys.extend(family_keys(fam, params))
    return tuple(keys)


def canonical_key(measure: str) -> Tuple[str, Optional[float]]:
    """One measure string (either dialect) → exactly one canonical key.

    For single-measure call sites: the string
    must resolve to a single output key, not a whole family's default grid.

    >>> canonical_key("nDCG@10")
    ('ndcg_cut_10', None)
    >>> canonical_key("AP(rel=2)")
    ('map', 2.0)
    """
    fam, params, rel = parse_single(measure)
    if params is None:
        if SPECS[fam].param_kind:
            params = SPECS[fam].default_params
            if len(params) != 1:
                raise MeasureError(
                    f"measure {measure!r} names a whole family; pick one key "
                    f"(e.g. {family_keys(fam, params[:1])[0]!r})")
        else:
            params = ()
    return family_keys(fam, params)[0], rel


# -- rendering ---------------------------------------------------------------


def render_trec(measure: str) -> str:
    """Either dialect → the canonical trec_eval output key."""
    return canonical_key(measure)[0]


def render_ir(key: str) -> str:
    """Canonical trec_eval key → the ir-measures spelling.

    >>> [render_ir(k) for k in ("recip_rank", "P_5", "iprec_at_recall_0.10")]
    ['RR', 'P@5', 'IPrec@0.10']
    """
    fam, param = split_key(key)
    spec = SPECS[fam]
    if param is None:
        return spec.ir_name
    if spec.param_kind == "p":
        return f"{spec.ir_name}(p={param:g})"
    if spec.param_kind == "level":
        return f"{spec.ir_name}@{param:.2f}"
    return f"{spec.ir_name}@{int(param)}"


def both_dialects(measure: str) -> str:
    """``'ndcg_cut_10' (ir-measures 'nDCG@10')`` — for error messages."""
    try:
        key = render_trec(measure)
        return f"{key!r} (ir-measures {render_ir(key)!r})"
    except MeasureError:
        return repr(measure)


# -- per-query column application (shared by full-sort and top-k paths) ------


def apply_columns(s, parsed: Parsed) -> Dict[str, object]:
    """Compute every requested per-query column over a ``SortedBatch``.

    The registry replacement for the old measure if-chain: each family's
    column function is resolved by name from :mod:`repro_torch.core.measures`
    and called once per parameter (or once, paramless).
    """
    from repro_torch.core import measures as M

    out = {}
    for fam, params in parsed:
        spec = SPECS[fam]
        fn = getattr(M, spec.column)
        if not spec.param_kind:
            out[fam] = fn(s)
        else:
            for key, p in zip(family_keys(fam, params), params):
                out[key] = fn(s, int(p) if spec.param_kind == "cutoff" else p)
    return out


# -- depth bounds (top-k routing) --------------------------------------------


def topk_depth(parsed: Parsed) -> Optional[int]:
    """Max ranking depth the measure set reads, or None if unbounded.

    ``None`` means some family needs the full ranking (full-sort path);
    an integer k means every requested column is determined by the top-k
    prefix (plus order-invariant scalars), so the evaluator may rank with
    the top-k kernel instead of sorting the whole document axis.
    """
    depth = 0
    for fam, params in parsed:
        spec = SPECS[fam]
        if spec.depth == "full":
            return None
        if spec.depth == "param":
            depth = max(depth, int(max(params)) if params else 0)
    return depth if depth > 0 else None


# -- -c missing-query contributions ------------------------------------------


def missing_contribution(key: str) -> str:
    """What a query judged in the qrels but absent from the run contributes
    under trec_eval ``-c``: ``"zero"``, ``"n_rel"`` (its R), or
    ``"log_gm_min"`` (a GM_MIN-clipped log term)."""
    return SPECS[split_key(key)[0]].missing
