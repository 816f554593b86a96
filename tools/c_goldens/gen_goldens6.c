/* Golden-fixture generator, part 6: the time-varying convolver (saf_TVConv),
 * multiConv (both partitioned modes) and the ambi_drc example end-to-end.
 *
 * saf_TVConv is driven across position CHANGES so its one-hop crossfade
 * machinery (current/last/last2 filter-set outputs + OLA carries,
 * saf_utility_matrixConv.c:548-) is pinned — the JAX implementation executes
 * the same recurrence as batched scan-free einsums.
 */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <math.h>

#include "saf.h"
#include "ambi_drc.h"

static FILE* manifest;
static const char* outdir;

static void dump(const char* name, const void* data, size_t n_elem,
                 const char* dtype, const char* shape)
{
    char path[512];
    size_t esz = strcmp(dtype, "c8") == 0 ? 8 : 4;
    snprintf(path, sizeof(path), "%s/%s.bin", outdir, name);
    FILE* f = fopen(path, "wb");
    if (!f) { perror(path); exit(1); }
    fwrite(data, esz, n_elem, f);
    fclose(f);
    fprintf(manifest, "%s %s %s\n", name, dtype, shape);
}

static unsigned int lcg_state = 777777u;
static float lcg_noise(void)
{
    lcg_state = lcg_state * 1664525u + 1013904223u;
    return (float)(lcg_state >> 8) / 8388608.0f - 1.0f;
}

/* -------------------------------------------------------------------- */
static void golden_tvconv(void)
{
    const int hop = 128, L = 512, nIRs = 3, nOut = 2, nHops = 12;
    int i, h;
    float** H = (float**)malloc2d(nIRs, nOut * L, sizeof(float));
    for (i = 0; i < nIRs; i++)
        for (h = 0; h < nOut * L; h++)
            H[i][h] = 0.3f * lcg_noise();
    float* x = malloc1d(nHops * hop * sizeof(float));
    for (i = 0; i < nHops * hop; i++)
        x[i] = lcg_noise();
    const int idx[12] = {0, 0, 0, 1, 1, 2, 2, 2, 0, 0, 1, 1};
    float idxf[12];
    for (i = 0; i < 12; i++) idxf[i] = (float)idx[i];

    void* hTVC;
    saf_TVConv_create(&hTVC, hop, H, L, nIRs, nOut, 0);
    float* out = malloc1d(nOut * nHops * hop * sizeof(float));
    float* outhop = malloc1d(nOut * hop * sizeof(float));
    for (h = 0; h < nHops; h++) {
        saf_TVConv_apply(hTVC, &x[h * hop], outhop, idx[h]);
        for (i = 0; i < nOut; i++)
            memcpy(&out[i * nHops * hop + h * hop], &outhop[i * hop],
                   hop * sizeof(float));
    }
    saf_TVConv_destroy(&hTVC);
    dump("tvc_H", FLATTEN2D(H), (size_t)nIRs * nOut * L, "f4", "3,2,512");
    dump("tvc_in", x, nHops * hop, "f4", "1536");
    dump("tvc_idx", idxf, 12, "f4", "12");
    dump("tvc_out", out, (size_t)nOut * nHops * hop, "f4", "2,1536");
    free(H); free(x); free(out); free(outhop);
}

/* -------------------------------------------------------------------- */
static void golden_multiconv(void)
{
    const int hop = 128, L = 300, nCH = 3, nHops = 8;
    int i, h, p;
    float* H = malloc1d(nCH * L * sizeof(float));
    for (i = 0; i < nCH * L; i++)
        H[i] = 0.3f * lcg_noise();
    float* x = malloc1d(nCH * nHops * hop * sizeof(float));
    for (i = 0; i < nCH * nHops * hop; i++)
        x[i] = lcg_noise();
    dump("mtc_H", H, (size_t)nCH * L, "f4", "3,300");
    dump("mtc_in", x, (size_t)nCH * nHops * hop, "f4", "3,1024");

    float* xhop = malloc1d(nCH * hop * sizeof(float));
    float* outhop = malloc1d(nCH * hop * sizeof(float));
    float* out = malloc1d(nCH * nHops * hop * sizeof(float));
    for (p = 0; p <= 1; p++) {
        void* hMC;
        saf_multiConv_create(&hMC, hop, H, L, nCH, p);
        for (h = 0; h < nHops; h++) {
            for (i = 0; i < nCH; i++)
                memcpy(&xhop[i * hop], &x[i * nHops * hop + h * hop],
                       hop * sizeof(float));
            saf_multiConv_apply(hMC, xhop, outhop);
            for (i = 0; i < nCH; i++)
                memcpy(&out[i * nHops * hop + h * hop], &outhop[i * hop],
                       hop * sizeof(float));
        }
        saf_multiConv_destroy(&hMC);
        dump(p ? "mtc_out_part" : "mtc_out_nonpart", out,
             (size_t)nCH * nHops * hop, "f4", "3,1024");
    }
    free(H); free(x); free(xhop); free(outhop); free(out);
}

/* -------------------------------------------------------------------- */
static void golden_ambi_drc(void)
{
    /* order 1 (4 SH channels), threshold -30 dB, ratio 8:1, knee 5 dB,
     * attack 20 ms, release 200 ms, in-gain +6 dB, out-gain +3 dB */
    const int fs = 48000, frame = 128, nCH = 4, nFrames = 64;
    const int sigLen = frame * nFrames;
    int i, f;
    void* hDrc;
    ambi_drc_create(&hDrc);
    ambi_drc_init(hDrc, fs);
    ambi_drc_setThreshold(hDrc, -30.0f);
    ambi_drc_setRatio(hDrc, 8.0f);
    ambi_drc_setKnee(hDrc, 5.0f);
    ambi_drc_setAttack(hDrc, 20.0f);
    ambi_drc_setRelease(hDrc, 200.0f);
    ambi_drc_setInGain(hDrc, 6.0f);
    ambi_drc_setOutGain(hDrc, 3.0f);

    float** in = (float**)malloc2d(nCH, sigLen, sizeof(float));
    /* amplitude-modulated noise so the compressor actually swings */
    for (i = 0; i < nCH; i++)
        for (f = 0; f < sigLen; f++)
            in[i][f] = lcg_noise()
                * (0.05f + 0.95f * 0.5f * (1.0f + sinf(2.0f * (float)M_PI
                                                       * f / 12000.0f)));
    float** inF = (float**)malloc2d(nCH, frame, sizeof(float));
    float** outF = (float**)malloc2d(nCH, frame, sizeof(float));
    float* out = malloc1d(nCH * sigLen * sizeof(float));
    for (f = 0; f < nFrames; f++) {
        for (i = 0; i < nCH; i++)
            memcpy(inF[i], &in[i][f * frame], frame * sizeof(float));
        ambi_drc_process(hDrc, (const float* const*)inF, outF, nCH, frame);
        for (i = 0; i < nCH; i++)
            memcpy(&out[i * sigLen + f * frame], outF[i],
                   frame * sizeof(float));
    }
    ambi_drc_destroy(&hDrc);
    dump("drc_in", FLATTEN2D(in), (size_t)nCH * sigLen, "f4", "4,8192");
    dump("drc_out", out, (size_t)nCH * sigLen, "f4", "4,8192");
    free(in); free(inF); free(outF); free(out);
}

/* -------------------------------------------------------------------- */
int main(int argc, char** argv)
{
    if (argc != 2) { fprintf(stderr, "usage: %s <outdir>\n", argv[0]); return 1; }
    outdir = argv[1];
    char mpath[512];
    snprintf(mpath, sizeof(mpath), "%s/manifest.txt", outdir);
    manifest = fopen(mpath, "a");
    if (!manifest) { perror(mpath); return 1; }

    golden_tvconv();
    printf("tvconv goldens done\n");
    golden_multiconv();
    printf("multiconv goldens done\n");
    golden_ambi_drc();
    printf("ambi_drc goldens done\n");

    fclose(manifest);
    return 0;
}
