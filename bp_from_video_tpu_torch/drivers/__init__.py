"""Entry-point drivers: sequential (reference bp.py) and pipelined
multi-stream (reference pbp.py)."""
