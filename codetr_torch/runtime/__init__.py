"""Export, save, reload and device timing of the served forward."""
