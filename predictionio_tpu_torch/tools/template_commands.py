"""``pio template`` subcommands: list/get.

Parity: ``tools/.../console/Template.scala:226-415`` — the reference
downloads engine templates from GitHub and personalizes the package name.
Templates here are importable packages rather than sbt projects, so
``get`` scaffolds an engine directory wired to a built-in template's
factory instead of cloning.

The port's copy of ``predictionio_tpu/tools/template_commands.py``. The
port has one template, ``recommendation``, whose ``engine.json`` names
the port's factory; ``list`` shows the JAX package's other templates as
not ported, and ``get`` raises for them (ROADMAP A7).
"""

from __future__ import annotations

import json
import os
import sys
from typing import Dict

PORT_FACTORY = ("predictionio_tpu_torch.templates.recommendation.engine"
                ":engine_factory")

BUILTIN_TEMPLATES: Dict[str, Dict] = {
    "recommendation": {
        "description": "Implicit-ALS top-N recommendation "
                       "(scala-parallel-recommendation parity)",
        "engineFactory": PORT_FACTORY,
        "variant": {
            "id": "default",
            "version": "default",
            "engineFactory": PORT_FACTORY,
            "datasource": {"params": {"appName": "INVALID_APP_NAME"}},
            "algorithms": [{
                "name": "als",
                "params": {"rank": 10, "numIterations": 10,
                           "lambda": 0.01, "seed": 3},
            }],
        },
    },
}

# the JAX package's other built-in templates, in its listing order
UNPORTED_TEMPLATES = (
    "classification", "similarproduct", "similarproduct-recommended-user",
    "helloworld", "friendrecommendation", "similarproduct-dimsum",
    "regression", "ecommercerecommendation", "sequentialrec", "twostage",
    "textclassification")


def dispatch(args) -> int:
    cmd = getattr(args, "template_command", None)
    if cmd == "list":
        return template_list()
    if cmd == "get":
        return template_get(args.name, args.directory)
    print("usage: pio template {list,get} ...", file=sys.stderr)
    return 2


def template_list() -> int:
    print(f"[INFO] {'Template':<26} | Description")
    for name, t in BUILTIN_TEMPLATES.items():
        print(f"[INFO] {name:<26} | {t['description']}")
    for name in UNPORTED_TEMPLATES:
        print(f"[INFO] {name:<26} | not ported yet (ROADMAP A7)")
    return 0


def template_get(name: str, directory: str) -> int:
    if name in UNPORTED_TEMPLATES:
        raise NotImplementedError(
            f"the {name} template is not ported yet (ROADMAP A7, the other "
            "templates); the port has: recommendation")
    t = BUILTIN_TEMPLATES.get(name)
    if t is None:
        print(f"[ERROR] Template {name} not found. Try 'pio template list'.",
              file=sys.stderr)
        return 1
    os.makedirs(directory, exist_ok=True)
    variant_path = os.path.join(directory, "engine.json")
    if os.path.exists(variant_path):
        print(f"[ERROR] {variant_path} already exists. Aborting.",
              file=sys.stderr)
        return 1
    with open(variant_path, "w", encoding="utf-8") as f:
        json.dump(t["variant"], f, indent=2)
        f.write("\n")
    with open(os.path.join(directory, "template.json"), "w",
              encoding="utf-8") as f:
        json.dump({"pio": {"version": {"min": "0.2.0"}}}, f)
        f.write("\n")
    print(f"[INFO] Engine template {name} is now ready at {directory}.")
    print("[INFO] Edit engine.json (set appName), then: "
          "pio build && pio train && pio deploy")
    return 0
