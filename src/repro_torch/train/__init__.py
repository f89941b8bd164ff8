"""Training: optimizers (`optim`), the train/eval/serve step builders
(`step`) and the pytree walk they share (`tree`)."""
