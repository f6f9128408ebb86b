"""``pio template`` subcommands: list/get.

Parity: ``tools/.../console/Template.scala:226-415`` — the reference
downloads engine templates from GitHub and personalizes the package name.
Templates here are importable packages rather than sbt projects, so
``get`` scaffolds an engine directory wired to a built-in template's
factory instead of cloning.

The port's copy of ``predictionio_tpu/tools/template_commands.py``: the
same twelve templates in the same order, each ``engine.json`` variant
the JAX package's except that its factory names the port's module.
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
    "classification": {
        "description": "Naive Bayes classification from $set properties "
                       "(scala-parallel-classification parity)",
        "engineFactory":
            "predictionio_tpu_torch.templates.classification:engine_factory",
        "variant": {
            "id": "default",
            "version": "default",
            "engineFactory":
                "predictionio_tpu_torch.templates.classification:engine_factory",
            "datasource": {"params": {"appName": "INVALID_APP_NAME"}},
            "algorithms": [{"name": "naive", "params": {"lambda": 1.0}}],
        },
    },
    "similarproduct": {
        "description": "Item-to-item similarity on view events "
                       "(scala-parallel-similarproduct parity)",
        "engineFactory":
            "predictionio_tpu_torch.templates.similarproduct:engine_factory",
        "variant": {
            "id": "default",
            "version": "default",
            "engineFactory":
                "predictionio_tpu_torch.templates.similarproduct:engine_factory",
            "datasource": {"params": {"appName": "INVALID_APP_NAME"}},
            "algorithms": [{
                "name": "als",
                "params": {"rank": 10, "numIterations": 20, "seed": 3},
            }],
        },
    },
    "similarproduct-recommended-user": {
        "description": "Who-to-follow via ALS on follow events "
                       "(similarproduct recommended-user variant parity)",
        "engineFactory":
            "predictionio_tpu_torch.templates.similarproduct"
            ":engine_factory_recommended_user",
        "variant": {
            "id": "default",
            "version": "default",
            "engineFactory":
                "predictionio_tpu_torch.templates.similarproduct"
                ":engine_factory_recommended_user",
            "datasource": {"params": {"appName": "INVALID_APP_NAME"}},
            "algorithms": [{
                "name": "als",
                "params": {"rank": 10, "numIterations": 20, "seed": 3},
            }],
        },
    },
    "helloworld": {
        "description": "L-flavor day->average-temperature engine "
                       "(experimental/scala-local-helloworld parity)",
        "engineFactory":
            "predictionio_tpu_torch.templates.helloworld:engine_factory",
        "variant": {
            "id": "default",
            "version": "default",
            "engineFactory":
                "predictionio_tpu_torch.templates.helloworld:engine_factory",
            "datasource": {"params": {"dataPath": "data.csv"}},
        },
    },
    "friendrecommendation": {
        "description": "Keyword-similarity friend/item acceptance on KDD "
                       "Cup 2012 data (experimental "
                       "scala-local-friend-recommendation parity)",
        "engineFactory":
            "predictionio_tpu_torch.templates.friendrecommendation"
            ":engine_factory",
        "variant": {
            "id": "default",
            "version": "default",
            "engineFactory":
                "predictionio_tpu_torch.templates.friendrecommendation"
                ":engine_factory",
            "datasource": {"params": {
                "itemFilePath": "data/item.txt",
                "userKeywordFilePath": "data/user_key_word.txt",
                "userActionFilePath": "data/user_action.txt"}},
        },
    },
    "similarproduct-dimsum": {
        "description": "Item-item cosine from the raw interaction matrix "
                       "(experimental similarproduct-dimsum parity)",
        "engineFactory":
            "predictionio_tpu_torch.templates.similarproduct"
            ":engine_factory_dimsum",
        "variant": {
            "id": "default",
            "version": "default",
            "engineFactory":
                "predictionio_tpu_torch.templates.similarproduct"
                ":engine_factory_dimsum",
            "datasource": {"params": {"appName": "INVALID_APP_NAME"}},
            "algorithms": [{"name": "dimsum",
                            "params": {"threshold": 0.1}}],
        },
    },
    "regression": {
        "description": "L-flavor OLS linear regression from a data file "
                       "(experimental/scala-local-regression parity)",
        "engineFactory":
            "predictionio_tpu_torch.templates.regression:engine_factory",
        "variant": {
            "id": "default",
            "version": "default",
            "engineFactory":
                "predictionio_tpu_torch.templates.regression:engine_factory",
            "datasource": {"params": {"filepath": "lr_data.txt"}},
            "preparator": {"params": {"n": 0, "k": 0}},
        },
    },
    "ecommercerecommendation": {
        "description": "ALS + business-rule filters at predict time "
                       "(scala-parallel-ecommercerecommendation parity)",
        "engineFactory":
            "predictionio_tpu_torch.templates.ecommercerecommendation"
            ":engine_factory",
        "variant": {
            "id": "default",
            "version": "default",
            "engineFactory":
                "predictionio_tpu_torch.templates.ecommercerecommendation"
                ":engine_factory",
            "datasource": {"params": {"appName": "INVALID_APP_NAME"}},
            "algorithms": [{
                "name": "als",
                "params": {"rank": 10, "numIterations": 20, "seed": 3},
            }],
        },
    },
    "sequentialrec": {
        "description": "SASRec-style next-item prediction over per-user "
                       "event sequences (causal transformer, served "
                       "through the device top-k store)",
        "engineFactory":
            "predictionio_tpu_torch.templates.sequentialrec:engine_factory",
        "variant": {
            "id": "default",
            "version": "default",
            "engineFactory":
                "predictionio_tpu_torch.templates.sequentialrec"
                ":engine_factory",
            "datasource": {"params": {"appName": "INVALID_APP_NAME"}},
            "preparator": {"params": {"maxSeqLen": 32}},
            "algorithms": [{
                "name": "seqrec",
                "params": {"rank": 32, "nLayers": 2, "nHeads": 2,
                           "numSteps": 300, "seed": 7},
            }],
        },
    },
    "twostage": {
        "description": "Two-stage serving: ALS retrieves N candidates, the "
                       "seqrec encoder re-ranks them, one device dispatch "
                       "per query batch",
        "engineFactory":
            "predictionio_tpu_torch.templates.twostage:engine_factory",
        "variant": {
            "id": "default",
            "version": "default",
            "engineFactory":
                "predictionio_tpu_torch.templates.twostage:engine_factory",
            "datasource": {"params": {"appName": "INVALID_APP_NAME"}},
            "preparator": {"params": {"maxSeqLen": 32}},
            "algorithms": [{
                "name": "als",
                "params": {"rank": 32, "numIterations": 10, "seed": 3},
            }, {
                "name": "seqrec",
                "params": {"rank": 32, "nLayers": 2, "nHeads": 2,
                           "numSteps": 300, "seed": 7},
            }],
        },
    },
    "textclassification": {
        "description": "Text -> label: hashed embedding table + LR "
                       "trained on the device, NB over token counts",
        "engineFactory":
            "predictionio_tpu_torch.templates.textclassification"
            ":engine_factory",
        "variant": {
            "id": "default",
            "version": "default",
            "engineFactory":
                "predictionio_tpu_torch.templates.textclassification"
                ":engine_factory",
            "datasource": {"params": {"appName": "INVALID_APP_NAME"}},
            "preparator": {"params": {"vocabSize": 4096,
                                      "maxTokens": 64}},
            "algorithms": [{
                "name": "lr",
                "params": {"embeddingDim": 64, "epochs": 30, "seed": 0},
            }],
        },
    },
}


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
    return 0


def template_get(name: str, directory: str) -> int:
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
