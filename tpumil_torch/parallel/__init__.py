"""Multi-device training over ``torch.distributed`` (counterpart of
tpumil/parallel/)."""
