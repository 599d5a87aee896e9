"""Serving: the paged KV cache, the FCFS scheduler, the paged decode step
and the static and continuous-batching engines."""
