from .ppl import evaluate_ppl
