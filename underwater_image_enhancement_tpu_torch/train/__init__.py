"""The parameter-predictor trainers (the JAX package's ``train/``):
``data`` (paired image folders -> batches) and ``trainer`` (MLPTrainer,
VGGTrainer, ZooTrainer)."""
