"""Training: AdamW (``optimizer``), the loss and the train step
(``train_step``), checkpoints (``checkpoint``) and int8 gradient
compression (``compression``), the counterparts of ``repro.training``."""
