"""Built-in model-config registry data (``model_configs_data.json``, the same
registry as the JAX package's). Models whose towers are not ported raise
``NotImplementedError`` when built, not when listed."""

import json
from pathlib import Path

with open(Path(__file__).parent / "model_configs_data.json") as _fh:
    BUILTIN_MODEL_CONFIGS = json.load(_fh)
