"""Rule registry: the ten invariants distilled from the repo's own
review history (see each rule's ``history`` for the bug it encodes)."""

from .atomic import AtomicWriteRule
from .eventloop import EventLoopRule
from .gather_ban import GatherBanRule
from .growth import BoundedGrowthRule
from .hotpath import HotPathRule
from .imports import ImportWeightRule
from .locks import LockDisciplineRule, ReleaseGuaranteeRule
from .metric_hygiene import MetricHygieneRule
from .threads import ThreadLifecycleRule

ALL_RULES = [
    LockDisciplineRule,
    ReleaseGuaranteeRule,
    ImportWeightRule,
    HotPathRule,
    EventLoopRule,
    GatherBanRule,
    BoundedGrowthRule,
    AtomicWriteRule,
    MetricHygieneRule,
    ThreadLifecycleRule,
]


def rule_table() -> list:
    """(name, invariant, history) rows — the README table's source."""
    return [(r.name, r.invariant, r.history) for r in ALL_RULES]
