"""Model serving of the port: ``ServeEngine`` (cold start from the compressed
store, greedy generation) and ``RequestBatcher`` (``repro/serve/engine.py``'s
counterpart; the HTTP store server is not ported yet)."""
