"""The figures of an evaluation's outputs (matplotlib, imported when a
figure is drawn)."""
