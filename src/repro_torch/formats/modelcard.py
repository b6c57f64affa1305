# Port copy of src/repro/formats/modelcard.py: host-only, logic unchanged.
"""Model-card / config metadata parsing for model-tree construction
(paper §4.4.3 step 3a).

The paper combines regular expressions with an LLM-based parser over
README.md / config.json to extract base-model lineage. This container has no
LLM endpoint, so the regex battery carries the full load (the LLM fallback is
stubbed — noted in DESIGN.md); the bit-distance matcher (step 3b) covers
whatever metadata misses, exactly as the paper designs it.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, Optional

__all__ = ["parse_base_model", "parse_repo_metadata"]

# YAML frontmatter / markdown patterns seen on the Hub
_PATTERNS = [
    re.compile(r"^base_model:\s*[\"']?([\w\-./]+)[\"']?\s*$", re.M),
    re.compile(r"^base_model_relation:.*$\n^base_model:\s*[\"']?([\w\-./]+)", re.M),
    re.compile(r"(?:fine[- ]?tuned?|adapter)\s+(?:of|from|for)\s+\[?([\w\-./]+)\]?", re.I),
    re.compile(r"This model is a fine-tuned version of \[([\w\-./]+)\]", re.I),
]


def parse_base_model(readme_text: str = "", config: Optional[Dict] = None) -> Optional[str]:
    """Extract the declared base model id, or None if metadata is missing."""
    for pat in _PATTERNS:
        m = pat.search(readme_text or "")
        if m:
            return m.group(1).strip()
    if config:
        for key in ("base_model", "_name_or_path", "parent_model"):
            v = config.get(key)
            if isinstance(v, str) and v and v not in (".", "/"):
                return v
    return None


def parse_repo_metadata(repo_dir: str) -> Dict[str, Optional[str]]:
    """Read config.json / README.md from a repo directory."""
    out: Dict[str, Optional[str]] = {"base_model": None, "architecture": None}
    cfg_path = os.path.join(repo_dir, "config.json")
    readme_path = os.path.join(repo_dir, "README.md")
    config = None
    if os.path.exists(cfg_path):
        try:
            with open(cfg_path) as f:
                config = json.load(f)
            archs = config.get("architectures")
            if archs:
                out["architecture"] = archs[0]
        except (json.JSONDecodeError, OSError):
            config = None
    readme = ""
    if os.path.exists(readme_path):
        try:
            with open(readme_path, encoding="utf-8", errors="replace") as f:
                readme = f.read()
        except OSError:
            pass
    out["base_model"] = parse_base_model(readme, config)
    return out
