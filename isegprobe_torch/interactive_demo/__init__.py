"""Interactive demo: the headless controller, the canvas and the Tk app."""
