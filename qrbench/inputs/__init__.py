"""One module an input distribution, named by a configuration's
``input["distribution"]``: ``make(shape, dtype, generator, device,
**params)`` draws one input from the generator, with the configuration's
other ``input`` keys as its parameters."""
