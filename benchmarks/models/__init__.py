"""Constructors of the port's models from a configuration file, one module
per family, named by the file's `family` key. Each makes the port's
model on the device and fills it with the harness's seeded weights."""
