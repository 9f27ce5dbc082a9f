// Standalone C++ host exercising the moonshine_tpu C ABI end to end
// against the PyTorch port's library (a copy of native/test_shim.cpp that
// writes its EXR to argv[1], default msn_shim_test.exr in the working
// directory). No Python in this binary; the shim embeds it.
//
//   g++ -std=c++17 test_shim.cpp -o test_shim -L<build> \
//       -lmoonshine_tpu_torch -Wl,-rpath,<build>

#include "moonshine_tpu.h"

#include <cmath>
#include <cstdio>
#include <cstdlib>

int main(int argc, char **argv) {
    const char *exr_path = argc > 1 ? argv[1] : "msn_shim_test.exr";
    MsnEngine *engine = MsnCreate();
    if (!engine) { std::fprintf(stderr, "create failed\n"); return 1; }

    // a ground quad and an emissive quad above it
    const MsnF32x3 quad[4] = {
        {-3, -3, 0}, {3, -3, 0}, {3, 3, 0}, {-3, 3, 0}};
    const MsnU32x3 idx[2] = {{0, 1, 2}, {0, 2, 3}};
    MsnMeshHandle mesh =
        MsnCreateMesh(engine, quad, 4, nullptr, 0, nullptr, 0, idx, 2);

    MsnImageHandle white = MsnCreateSolidTexture3(engine, {0.8f, 0.8f, 0.8f});
    MsnImageHandle black = MsnCreateSolidTexture3(engine, {0, 0, 0});
    MsnImageHandle rough = MsnCreateSolidTexture1(engine, 1.0f);
    MsnImageHandle metal = MsnCreateSolidTexture1(engine, 0.0f);

    MsnMaterial floor_mat = {MSN_NO_IMAGE, black, white, metal, rough, 1.5f};
    MsnMaterialHandle floor = MsnCreateMaterial(engine, floor_mat);

    MsnMat3x4 ident = {{1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0}};
    MsnGeometry geom = {mesh, floor, false};
    MsnInstanceHandle inst = MsnCreateInstance(engine, ident, &geom, 1, true);
    if (inst == (MsnInstanceHandle)-1) {
        std::fprintf(stderr, "create_instance failed\n");
        return 10;
    }

    MsnSensorHandle sensor = MsnCreateSensor(engine, {32, 24});
    MsnLens lens = {{0, -4, 2}, {0, 0.92f, -0.38f}, {0, 0, 1},
                    0.8f, 0.0f, 1.0f};
    MsnLensHandle lens_h = MsnCreateLens(engine, lens);

    for (int i = 0; i < 2; ++i) {
        if (!MsnRender(engine, sensor, lens_h)) {
            std::fprintf(stderr, "render failed\n");
            return 2;
        }
    }
    if (MsnGetSensorSampleCount(engine, sensor) != 2) {
        std::fprintf(stderr, "bad sample count\n");
        return 3;
    }

    const float *pixels = MsnGetSensorData(engine, sensor);
    double mean = 0;
    bool finite = true;
    for (int i = 0; i < 32 * 24 * 4; ++i) {
        mean += pixels[i];
        finite &= std::isfinite(pixels[i]);
    }
    mean /= 32 * 24 * 4;
    if (!finite || mean <= 0.01) {
        std::fprintf(stderr, "bad image: mean=%f finite=%d\n", mean, finite);
        return 4;
    }
    // the floor must actually shade some pixels darker than the white env
    bool has_floor = false;
    for (int i = 0; i < 32 * 24; ++i)
        has_floor |= pixels[i * 4] < 0.95f;
    if (!has_floor) {
        std::fprintf(stderr, "floor not visible — scene upload broken\n");
        return 11;
    }

    // live edit: hide the floor, reset-by-new-sensor, render again
    MsnSetInstanceVisibility(engine, inst, false);
    MsnSensorHandle sensor2 = MsnCreateSensor(engine, {8, 8});
    if (!MsnRender(engine, sensor2, lens_h)) return 5;

    // EXR round trip through the native codec
    const float *img = MsnGetSensorData(engine, sensor);
    if (MsnExrWrite(exr_path, img, 32, 24, 4) != 0) return 6;
    float *back = nullptr;
    uint32_t w = 0, h = 0;
    if (MsnExrRead(exr_path, &back, &w, &h) != 0) return 7;
    if (w != 32 || h != 24) return 8;
    for (int i = 0; i < 32 * 24 * 4; ++i) {
        if (back[i] != img[i]) {
            std::fprintf(stderr, "exr mismatch at %d\n", i);
            return 9;
        }
    }
    MsnExrFree(back);

    MsnDestroy(engine);
    std::printf("shim ok: mean=%.4f\n", mean);
    return 0;
}
