"""e2: the framework-independent algorithm library (categorical naive
Bayes, Markov chain, one-hot vectorizer, k-fold splitting, random
forest).

The port's own copy of ``predictionio_tpu/e2``: host numpy, kept line
for line so its results are bitwise the JAX package's.
"""

from predictionio_tpu_torch.e2.engine import (  # noqa: F401
    BinaryVectorizer,
    CategoricalNaiveBayes,
    CategoricalNaiveBayesModel,
    LabeledPoint,
    MarkovChain,
    MarkovChainModel,
)
from predictionio_tpu_torch.e2.evaluation import split_data  # noqa: F401
from predictionio_tpu_torch.e2.forest import (  # noqa: F401
    RandomForestModel,
    train_classifier,
)
