"""The port's C ABI: `moonshine_tpu.h` (a byte-identical copy of the JAX
package's native/moonshine_tpu.h), the shim that embeds Python running
`moonshine_tpu_torch.capi` (`engine_shim.cpp`), a C++ host that drives it
end to end (`test_shim.cpp`), and `build`, which compiles them."""
