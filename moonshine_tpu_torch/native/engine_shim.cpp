// C ABI engine shim of the PyTorch port: embeds CPython running the
// moonshine_tpu_torch engine (port of native/engine_shim.cpp).
//
// The ABI is moonshine_tpu.h, a byte-identical copy of native/'s, so a host
// built against either library (native/test_shim.cpp, the Hydra delegate
// core native/hydra/) links this one unchanged. Hosts drive the renderer
// without knowing about Python or torch; every call funnels through
// moonshine_tpu_torch.capi (flat ints/floats/memoryviews). The EXR entry
// points (MsnExr*) go through the port's own codec (io/exr.py) by
// capi.exr_write / capi.exr_read, so the port has no second C++ codec.
// Built by moonshine_tpu_torch/native/build.py into
// build/libmoonshine_tpu_torch.so.
//
// Threading: one global interpreter; every entry point takes the GIL, the
// analogue of the upstream engine mutex (hydra.zig:77-78). In a Python
// process (ctypes) the running interpreter is used.

#include "moonshine_tpu.h"

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>

namespace {

struct PyGuard {
    PyGILState_STATE state;
    PyGuard() : state(PyGILState_Ensure()) {}
    ~PyGuard() { PyGILState_Release(state); }
};

PyObject *g_capi = nullptr;
std::once_flag g_init_once;

void initialize_python() {
    std::call_once(g_init_once, [] {
        if (!Py_IsInitialized()) {
            Py_InitializeEx(0);
            // release the GIL acquired by Py_Initialize so PyGuard works
            // from any thread, including this one
            PyEval_SaveThread();
        }
        PyGuard gil;
        g_capi = PyImport_ImportModule("moonshine_tpu_torch.capi");
        if (!g_capi) {
            PyErr_Print();
            std::fprintf(stderr,
                         "moonshine_tpu_torch: failed to import capi "
                         "module; is the package on PYTHONPATH?\n");
        }
    });
}

// call capi.<name>(args...) -> new reference or nullptr (error printed)
PyObject *capi_call(const char *name, PyObject *args) {
    if (!g_capi) {
        Py_XDECREF(args);
        return nullptr;
    }
    PyObject *fn = PyObject_GetAttrString(g_capi, name);
    if (!fn) {
        PyErr_Print();
        Py_XDECREF(args);
        return nullptr;
    }
    PyObject *result = PyObject_CallObject(fn, args);
    Py_DECREF(fn);
    Py_XDECREF(args);
    if (!result) PyErr_Print();
    return result;
}

long call_long(const char *name, PyObject *args, long fallback = -1) {
    PyObject *r = capi_call(name, args);
    if (!r) return fallback;
    long v = PyLong_AsLong(r);
    Py_DECREF(r);
    return v;
}

bool call_bool(const char *name, PyObject *args) {
    PyObject *r = capi_call(name, args);
    if (!r) return false;
    bool v = PyObject_IsTrue(r) == 1;
    Py_DECREF(r);
    return v;
}

void call_void(const char *name, PyObject *args) {
    PyObject *r = capi_call(name, args);
    Py_XDECREF(r);
}

PyObject *mem(const void *data, Py_ssize_t bytes) {
    if (!data || bytes == 0) Py_RETURN_NONE;
    return PyMemoryView_FromMemory(
        reinterpret_cast<char *>(const_cast<void *>(data)), bytes,
        PyBUF_READ);
}

long engine_id(MsnEngine *e) {
    return static_cast<long>(reinterpret_cast<intptr_t>(e));
}

PyObject *lens_args(long eng, long handle_or_skip, const MsnLens &l,
                    bool with_handle) {
    if (with_handle)
        return Py_BuildValue("(llffffffffffff)", eng, handle_or_skip,
                             l.origin.x, l.origin.y, l.origin.z, l.forward.x,
                             l.forward.y, l.forward.z, l.up.x, l.up.y, l.up.z,
                             l.vfov, l.aperture, l.focus_distance);
    return Py_BuildValue("(lffffffffffff)", eng, l.origin.x, l.origin.y,
                         l.origin.z, l.forward.x, l.forward.y, l.forward.z,
                         l.up.x, l.up.y, l.up.z, l.vfov, l.aperture,
                         l.focus_distance);
}

}  // namespace

extern "C" {

MsnEngine *MsnCreate(void) {
    initialize_python();
    PyGuard gil;
    long handle = call_long("create", nullptr, 0);
    return reinterpret_cast<MsnEngine *>(static_cast<intptr_t>(handle));
}

void MsnDestroy(MsnEngine *e) {
    PyGuard gil;
    call_void("destroy", Py_BuildValue("(l)", engine_id(e)));
}

bool MsnRender(MsnEngine *e, MsnSensorHandle sensor, MsnLensHandle lens) {
    PyGuard gil;
    return call_bool("render", Py_BuildValue("(lll)", engine_id(e),
                                             (long)sensor, (long)lens));
}

bool MsnRebuildPipeline(MsnEngine *e) {
    PyGuard gil;
    return call_bool("rebuild_pipeline", Py_BuildValue("(l)", engine_id(e)));
}

MsnMeshHandle MsnCreateMesh(MsnEngine *e, const MsnF32x3 *positions,
                            size_t position_count, const MsnF32x3 *normals,
                            size_t normal_count, const MsnF32x2 *texcoords,
                            size_t texcoord_count, const MsnU32x3 *indices,
                            size_t index_count) {
    PyGuard gil;
    PyObject *args = Py_BuildValue(
        "(lNNNN)", engine_id(e),
        mem(positions, (Py_ssize_t)(position_count * sizeof(MsnF32x3))),
        mem(normals, (Py_ssize_t)(normal_count * sizeof(MsnF32x3))),
        mem(texcoords, (Py_ssize_t)(texcoord_count * sizeof(MsnF32x2))),
        mem(indices, (Py_ssize_t)(index_count * sizeof(MsnU32x3))));
    return (MsnMeshHandle)call_long("create_mesh", args);
}

MsnImageHandle MsnCreateSolidTexture1(MsnEngine *e, float v) {
    PyGuard gil;
    return (MsnImageHandle)call_long("create_solid_texture1",
                                     Py_BuildValue("(lf)", engine_id(e), v));
}

MsnImageHandle MsnCreateSolidTexture2(MsnEngine *e, MsnF32x2 v) {
    PyGuard gil;
    return (MsnImageHandle)call_long(
        "create_solid_texture2", Py_BuildValue("(lff)", engine_id(e), v.x, v.y));
}

MsnImageHandle MsnCreateSolidTexture3(MsnEngine *e, MsnF32x3 v) {
    PyGuard gil;
    return (MsnImageHandle)call_long(
        "create_solid_texture3",
        Py_BuildValue("(lfff)", engine_id(e), v.x, v.y, v.z));
}

MsnImageHandle MsnCreateRawTexture(MsnEngine *e, const uint8_t *data,
                                   MsnExtent2D extent, MsnTextureFormat fmt) {
    PyGuard gil;
    size_t bytes = (size_t)extent.width * extent.height * 4 *
                   (fmt == MSN_TEXTURE_F16X4 ? 2 : 1);
    PyObject *args =
        Py_BuildValue("(lNlll)", engine_id(e), mem(data, (Py_ssize_t)bytes),
                      (long)extent.width, (long)extent.height, (long)fmt);
    return (MsnImageHandle)call_long("create_raw_texture", args);
}

MsnMaterialHandle MsnCreateMaterial(MsnEngine *e, MsnMaterial m) {
    PyGuard gil;
    long normal = m.normal == MSN_NO_IMAGE ? -1 : (long)m.normal;
    return (MsnMaterialHandle)call_long(
        "create_material",
        Py_BuildValue("(llllllf)", engine_id(e), normal, (long)m.emissive,
                      (long)m.color, (long)m.metalness, (long)m.roughness,
                      m.ior));
}

#define MSN_SET_MATERIAL(fn, pyname)                                         \
    void fn(MsnEngine *e, MsnMaterialHandle mat, MsnImageHandle img) {       \
        PyGuard gil;                                                         \
        call_void(pyname, Py_BuildValue("(lll)", engine_id(e), (long)mat,    \
                                        (long)img));                         \
    }

MSN_SET_MATERIAL(MsnSetMaterialNormal, "set_material_normal")
MSN_SET_MATERIAL(MsnSetMaterialEmissive, "set_material_emissive")
MSN_SET_MATERIAL(MsnSetMaterialColor, "set_material_color")
MSN_SET_MATERIAL(MsnSetMaterialMetalness, "set_material_metalness")
MSN_SET_MATERIAL(MsnSetMaterialRoughness, "set_material_roughness")

void MsnSetMaterialIOR(MsnEngine *e, MsnMaterialHandle mat, float ior) {
    PyGuard gil;
    call_void("set_material_ior",
              Py_BuildValue("(llf)", engine_id(e), (long)mat, ior));
}

MsnInstanceHandle MsnCreateInstance(MsnEngine *e, MsnMat3x4 transform,
                                    const MsnGeometry *geometries,
                                    size_t count, bool visible) {
    PyGuard gil;
    // re-pack geometries as tight u32 triples (MsnGeometry has padding)
    uint32_t *packed = new uint32_t[count * 3];
    for (size_t i = 0; i < count; ++i) {
        packed[i * 3 + 0] = geometries[i].mesh;
        packed[i * 3 + 1] = geometries[i].material;
        packed[i * 3 + 2] = geometries[i].sampled ? 1u : 0u;
    }
    PyObject *args = Py_BuildValue(
        "(ly#y#i)", engine_id(e), (const char *)transform.m,
        (Py_ssize_t)sizeof(transform.m), (const char *)packed,
        (Py_ssize_t)(count * 3 * sizeof(uint32_t)), visible ? 1 : 0);
    long handle = call_long("create_instance", args);
    delete[] packed;
    return (MsnInstanceHandle)handle;
}

void MsnDestroyInstance(MsnEngine *e, MsnInstanceHandle inst) {
    PyGuard gil;
    call_void("destroy_instance",
              Py_BuildValue("(ll)", engine_id(e), (long)inst));
}

void MsnSetInstanceTransform(MsnEngine *e, MsnInstanceHandle inst,
                             MsnMat3x4 transform) {
    PyGuard gil;
    call_void("set_instance_transform",
              Py_BuildValue("(lly#)", engine_id(e), (long)inst,
                            (const char *)transform.m,
                            (Py_ssize_t)sizeof(transform.m)));
}

void MsnSetInstanceVisibility(MsnEngine *e, MsnInstanceHandle inst,
                              bool visible) {
    PyGuard gil;
    call_void("set_instance_visibility",
              Py_BuildValue("(lli)", engine_id(e), (long)inst,
                            visible ? 1 : 0));
}

MsnSensorHandle MsnCreateSensor(MsnEngine *e, MsnExtent2D extent) {
    PyGuard gil;
    return (MsnSensorHandle)call_long(
        "create_sensor", Py_BuildValue("(lll)", engine_id(e),
                                       (long)extent.width,
                                       (long)extent.height));
}

float *MsnGetSensorData(const MsnEngine *e, MsnSensorHandle sensor) {
    PyGuard gil;
    long addr = call_long(
        "get_sensor_data_ptr",
        Py_BuildValue("(ll)", engine_id(const_cast<MsnEngine *>(e)),
                      (long)sensor),
        0);
    return reinterpret_cast<float *>(static_cast<intptr_t>(addr));
}

uint32_t MsnGetSensorSampleCount(const MsnEngine *e, MsnSensorHandle sensor) {
    PyGuard gil;
    return (uint32_t)call_long(
        "sample_count",
        Py_BuildValue("(ll)", engine_id(const_cast<MsnEngine *>(e)),
                      (long)sensor),
        0);
}

MsnLensHandle MsnCreateLens(MsnEngine *e, MsnLens lens) {
    PyGuard gil;
    return (MsnLensHandle)call_long("create_lens",
                                    lens_args(engine_id(e), 0, lens, false));
}

void MsnSetLens(MsnEngine *e, MsnLensHandle handle, MsnLens lens) {
    PyGuard gil;
    call_void("set_lens", lens_args(engine_id(e), (long)handle, lens, true));
}

// --- EXR codec: the port's io/exr.py through capi ---

int MsnExrWrite2(const char *path, const float *rgb, uint32_t width,
                 uint32_t height, uint32_t channels, uint32_t compression) {
    if (!path || !rgb) return 1;
    initialize_python();
    PyGuard gil;
    PyObject *args = Py_BuildValue(
        "(sNkkkk)", path,
        mem(rgb, (Py_ssize_t)((size_t)width * height * channels *
                              sizeof(float))),
        (unsigned long)width, (unsigned long)height,
        (unsigned long)channels, (unsigned long)compression);
    return (int)call_long("exr_write", args, 2);
}

int MsnExrWrite(const char *path, const float *rgb, uint32_t width,
                uint32_t height, uint32_t channels) {
    return MsnExrWrite2(path, rgb, width, height, channels, 3 /* ZIP */);
}

int MsnExrRead(const char *path, float **out_rgba, uint32_t *out_width,
               uint32_t *out_height) {
    if (!path || !out_rgba || !out_width || !out_height) return 1;
    initialize_python();
    PyGuard gil;
    // capi.exr_read -> (RGBA float32 bytes, width, height)
    PyObject *r = capi_call("exr_read", Py_BuildValue("(s)", path));
    if (!r) return 3;
    const char *data = nullptr;
    Py_ssize_t bytes = 0;
    unsigned long w = 0, h = 0;
    int rc = 0;
    if (!PyArg_ParseTuple(r, "y#kk", &data, &bytes, &w, &h)) {
        PyErr_Print();
        rc = 4;
    } else if ((size_t)bytes != (size_t)w * h * 4 * sizeof(float)) {
        rc = 5;
    } else {
        float *buf = static_cast<float *>(std::malloc(bytes ? bytes : 1));
        if (!buf) {
            rc = 6;
        } else {
            std::memcpy(buf, data, (size_t)bytes);
            *out_rgba = buf;
            *out_width = (uint32_t)w;
            *out_height = (uint32_t)h;
        }
    }
    Py_DECREF(r);
    return rc;
}

void MsnExrFree(float *p) { std::free(p); }

}  // extern "C"
