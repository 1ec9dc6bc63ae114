"""Roofline of the port: FLOPs and bytes counted by dispatch
(``op_stats``) and the H100 roofline terms (``analysis``)."""
