"""Aggregation semantics: sparsifiers, the five algorithms, the chain,
TCS masks, error feedback and the §V closed forms."""
