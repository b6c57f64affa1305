# Port copy of src/repro/formats/__init__.py.
"""Model serialization formats (dependency-free safetensors, model cards)."""
