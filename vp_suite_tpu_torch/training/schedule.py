r"""Learning-rate scheduling: the reference's ``ReduceLROnPlateau(patience=5,
factor=0.2, min_lr=1e-6)``, stepped on the host with each epoch's validation
indicator; :func:`set_learning_rate` writes the rate into the optimizer."""
import torch


class ReduceLROnPlateau:
    def __init__(self, lr, mode="min", factor=0.2, patience=5, min_lr=1e-6):
        self.lr = lr
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.min_lr = min_lr
        self.best = None
        self.num_bad_epochs = 0

    def step(self, metric) -> float:
        r"""Updates with the epoch's indicator value; returns the current lr."""
        metric = float(metric)
        if self.best is None:
            self.best = metric
        else:
            improved = metric < self.best if self.mode == "min" else metric > self.best
            if improved:
                self.best = metric
                self.num_bad_epochs = 0
            else:
                self.num_bad_epochs += 1
                if self.num_bad_epochs > self.patience:
                    self.lr = max(self.lr * self.factor, self.min_lr)
                    self.num_bad_epochs = 0
        return self.lr


def set_learning_rate(state, lr):
    r"""Writes ``lr`` into every parameter group of the state's optimizer
    (a state without one is left as it is); returns the state. A rate held
    as a tensor on the card is filled in place, so that the steps captured
    in a CUDA graph read it on their next replay."""
    for group in state.optimizer.param_groups if state.optimizer is not None else ():
        if torch.is_tensor(group["lr"]):
            group["lr"].fill_(lr)
        else:
            group["lr"] = lr
    return state
