"""The plain reference of a training step: VONet's unroll with BA in the
loop, the clip loss and the optimizer chain, in f32."""
