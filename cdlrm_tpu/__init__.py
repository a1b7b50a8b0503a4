"""cdlrm_tpu: JAX/XLA DLRM training framework with lookahead embedding
caching (the cDLRM design, RecSys '21), built on jit and shard_map.

See DESIGN.md for the architecture and SURVEY.md for the reference analysis.
"""

__version__ = "0.1.0"
