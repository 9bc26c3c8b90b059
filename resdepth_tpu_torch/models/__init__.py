"""Eval-mode UNet, serving folds and checkpoint readers."""
