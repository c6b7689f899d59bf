"""Training: the train state, its initialisation and the stage steps."""
