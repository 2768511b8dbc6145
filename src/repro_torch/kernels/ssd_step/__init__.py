"""The Mamba-2 decode step's state update and readout (no Pallas
counterpart)."""
