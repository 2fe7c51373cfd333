from repro_torch.eval.perplexity import (  # noqa: F401
    eval_suite, perplexity, successor_accuracy,
)
