// Writes and reads OpenEXR files through libOpenEXR, for
// `tools/gen_torch_exr.py`, which makes the test files of the port's
// OpenEXR decoder (`vision_tpu_torch/scene/imageio.py` `read_exr`) and the
// decodes they are held against. Built by that script with g++:
//
//   g++ -O2 -std=c++17 -I<OpenEXR> -I<Imath> exr_tool.cpp \
//       -lOpenEXR -lImath -lIex -o exr_tool
//
//   exr_tool write OUT.exr SPEC PLANES.f32
//   exr_tool read IN.exr PLANES.f32
//
// SPEC is one `key=value` a line:
//   width, height, xmin, ymin      the data window
//   channels=R:HALF,G:HALF,...     name:type[:xs:ys] (HALF, FLOAT, UINT;
//                                  x and y sampling, 1 unless given) in
//                                  the order of the planes in PLANES.f32
//   plinear=R,G,...                the channels marked perceptually linear
//   chromaticities=rx,ry,gx,gy,bx,by,wx,wy   a chromaticities attribute
//   deepk=K                        deep layouts: up to K samples a pixel
//   compression=N                  Imf::Compression
//   lineorder=N                    Imf::LineOrder
//   tile=X,Y,MODE,ROUNDING         a tiled file (level mode, rounding mode)
//   layout=scanline|tiled|multipart|deepscanline|deeptiled|yc
//   dwa=LEVEL                      dwaCompressionLevel
// PLANES.f32 holds one float32 [height, width] plane per channel; a UINT
// channel takes each value cast to uint32, a sub-sampled one the values
// at the pixels whose x and y its sampling divides. The levels of a mip-
// or ripmap other than (0, 0) repeat the top-left corner of level 0.
// `multipart` writes the spec as part 0 and a ZIP scanline part "second"
// of its channels halved after it; `deepscanline` / `deeptiled` write one
// sample a pixel, or with `deepk=K` a pixel's sample count (plane 0, at
// most K) then K planes a channel, sample k of each pixel in plane k;
// `yc` writes the R, G, B planes through RgbaOutputFile's luminance-chroma
// mode (Y, RY, BY; RY and BY sub-sampled 2 x 2).
//
// `read` opens the file as OpenCV's EXR decoder does, with Imf::InputFile
// (part 0 of a multi-part file, level (0, 0) of a tiled one), and writes
// each channel of the header (sorted by name) as float32 [height / ys,
// width / xs] through a FLOAT slice of its sampling; it prints `ok` then
// `name type xs ys` a channel and the data window, or `error <message>`
// and exits 2 when InputFile throws.

#include <ImfChannelList.h>
#include <ImfDeepFrameBuffer.h>
#include <ImfDeepScanLineOutputFile.h>
#include <ImfDeepTiledOutputFile.h>
#include <ImfFrameBuffer.h>
#include <ImfHeader.h>
#include <ImfInputFile.h>
#include <ImfMultiPartOutputFile.h>
#include <ImfOutputFile.h>
#include <ImfOutputPart.h>
#include <ImfPartType.h>
#include <ImfRgbaFile.h>
#include <ImfStandardAttributes.h>
#include <ImfTiledOutputFile.h>
#include <ImfTiledOutputPart.h>
#include <half.h>

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <fstream>
#include <map>
#include <sstream>
#include <string>
#include <vector>

using namespace Imf;
using namespace Imath;

namespace {

struct Chan {
  std::string name;
  PixelType type;
  int xs = 1, ys = 1;
  bool plinear = false;
};

struct Spec {
  int width = 0, height = 0, xmin = 0, ymin = 0;
  std::vector<Chan> chans;
  int compression = 0, lineorder = 0;
  int tx = 0, ty = 0, mode = 0, rounding = 0;
  std::string layout = "scanline";
  float dwa = -1.0f;
  int deepk = 0;
  std::vector<float> chroma;
};

PixelType parse_type(const std::string &s) {
  if (s == "HALF") return HALF;
  if (s == "FLOAT") return FLOAT;
  if (s == "UINT") return UINT;
  throw std::runtime_error("bad pixel type " + s);
}

const char *type_name(PixelType t) {
  return t == HALF ? "HALF" : t == FLOAT ? "FLOAT" : "UINT";
}

Spec read_spec(const char *path) {
  Spec s;
  std::ifstream f(path);
  std::string line, plinear;
  while (std::getline(f, line)) {
    auto eq = line.find('=');
    if (eq == std::string::npos) continue;
    std::string k = line.substr(0, eq), v = line.substr(eq + 1);
    if (k == "width") s.width = std::stoi(v);
    else if (k == "height") s.height = std::stoi(v);
    else if (k == "xmin") s.xmin = std::stoi(v);
    else if (k == "ymin") s.ymin = std::stoi(v);
    else if (k == "compression") s.compression = std::stoi(v);
    else if (k == "lineorder") s.lineorder = std::stoi(v);
    else if (k == "layout") s.layout = v;
    else if (k == "dwa") s.dwa = std::stof(v);
    else if (k == "deepk") s.deepk = std::stoi(v);
    else if (k == "tile") {
      std::sscanf(v.c_str(), "%d,%d,%d,%d", &s.tx, &s.ty, &s.mode, &s.rounding);
    } else if (k == "channels") {
      std::stringstream ss(v);
      std::string item;
      while (std::getline(ss, item, ',')) {
        std::stringstream is(item);
        std::string name, type, xs = "1", ys = "1";
        std::getline(is, name, ':');
        std::getline(is, type, ':');
        std::getline(is, xs, ':');
        std::getline(is, ys, ':');
        s.chans.push_back({name, parse_type(type), std::stoi(xs), std::stoi(ys)});
      }
    } else if (k == "chromaticities") {
      std::stringstream ss(v);
      std::string item;
      while (std::getline(ss, item, ',')) s.chroma.push_back(std::stof(item));
    } else if (k == "plinear") {
      plinear = v;
    }
  }
  std::stringstream ss(plinear);
  std::string item;
  while (std::getline(ss, item, ','))
    for (auto &c : s.chans)
      if (c.name == item) c.plinear = true;
  return s;
}

// One channel's pixels in its own type, row-major [h, w].
// A sub-sampled channel keeps [height / ys, width / xs] samples.
struct Plane {
  std::vector<half> h;
  std::vector<float> f;
  std::vector<uint32_t> u;
  PixelType type;
  int xs = 1, ys = 1;
  char *data() {
    return type == HALF ? (char *)h.data() : type == FLOAT ? (char *)f.data()
                                                           : (char *)u.data();
  }
  char *base(int w, int xmin, int ymin) {
    return data() - (ptrdiff_t(ymin / ys) * (w / xs) + xmin / xs) * stride();
  }
  size_t stride() const { return type == HALF ? 2 : 4; }
  void push(float v) {
    if (type == HALF) h.push_back(half(v));
    else if (type == FLOAT) f.push_back(v);
    else u.push_back(uint32_t(v));
  }
};

std::vector<Plane> make_planes(const Spec &s, const std::vector<float> &data) {
  std::vector<Plane> planes(s.chans.size());
  size_t n = size_t(s.width) * s.height;
  for (size_t c = 0; c < s.chans.size(); ++c) {
    Plane &p = planes[c];
    p.type = s.chans[c].type;
    p.xs = s.chans[c].xs;
    p.ys = s.chans[c].ys;
    for (int y = 0; y < s.height; y += p.ys)
      for (int x = 0; x < s.width; x += p.xs)
        p.push(data[c * n + size_t(y) * s.width + x]);
  }
  return planes;
}

Header make_header(const Spec &s) {
  Box2i dw(V2i(s.xmin, s.ymin), V2i(s.xmin + s.width - 1, s.ymin + s.height - 1));
  Header h(dw, dw);
  h.compression() = Compression(s.compression);
  h.lineOrder() = LineOrder(s.lineorder);
  for (auto &c : s.chans)
    h.channels().insert(c.name, Channel(c.type, c.xs, c.ys, c.plinear));
  if (s.dwa >= 0) h.dwaCompressionLevel() = s.dwa;
  if (s.chroma.size() == 8)
    addChromaticities(h, Chromaticities(V2f(s.chroma[0], s.chroma[1]),
                                        V2f(s.chroma[2], s.chroma[3]),
                                        V2f(s.chroma[4], s.chroma[5]),
                                        V2f(s.chroma[6], s.chroma[7])));
  if (s.tx > 0)
    h.setTileDescription(TileDescription(s.tx, s.ty, LevelMode(s.mode),
                                         LevelRoundingMode(s.rounding)));
  return h;
}

FrameBuffer frame(const Spec &s, std::vector<Plane> &planes) {
  FrameBuffer fb;
  for (size_t c = 0; c < planes.size(); ++c) {
    Plane &p = planes[c];
    fb.insert(s.chans[c].name,
              Slice(p.type, p.base(s.width, s.xmin, s.ymin), p.stride(),
                    p.stride() * (s.width / p.xs), p.xs, p.ys));
  }
  return fb;
}

void write_tiled(const Spec &s, std::vector<Plane> &planes, const char *out) {
  TiledOutputFile f(out, make_header(s));
  f.setFrameBuffer(frame(s, planes));
  // every level repeats level 0's top-left corner: its frame buffer is
  // level 0's, which covers any smaller level's window
  for (int ly = 0; ly < f.numYLevels(); ++ly)
    for (int lx = 0; lx < f.numXLevels(); ++lx) {
      if (s.mode != RIPMAP_LEVELS && lx != ly) continue;
      f.writeTiles(0, f.numXTiles(lx) - 1, 0, f.numYTiles(ly) - 1, lx, ly);
    }
}

void write_multipart(const Spec &s, std::vector<Plane> &planes, const char *out) {
  Header h0 = make_header(s);
  h0.setName("first");
  h0.setType(s.tx > 0 ? TILEDIMAGE : SCANLINEIMAGE);
  Spec s1 = s;
  s1.width = s.width / 2 + 1;
  s1.height = s.height / 2 + 1;
  s1.tx = 0;
  s1.compression = ZIP_COMPRESSION;
  Header h1 = make_header(s1);
  h1.displayWindow() = h0.displayWindow();  // an attribute parts share
  h1.setName("second");
  h1.setType(SCANLINEIMAGE);
  MultiPartOutputFile f(out, std::vector<Header>{h0, h1}.data(), 2);
  if (s.tx > 0) {
    TiledOutputPart p0(f, 0);
    p0.setFrameBuffer(frame(s, planes));
    p0.writeTiles(0, p0.numXTiles(0) - 1, 0, p0.numYTiles(0) - 1, 0, 0);
  } else {
    OutputPart p0(f, 0);
    p0.setFrameBuffer(frame(s, planes));
    p0.writePixels(s.height);
  }
  OutputPart p1(f, 1);
  // part 1's window is the top-left corner of part 0's planes
  FrameBuffer fb;
  for (size_t c = 0; c < planes.size(); ++c) {
    Plane &p = planes[c];
    fb.insert(s.chans[c].name,
              Slice(p.type, p.base(s.width, s.xmin, s.ymin), p.stride(),
                    p.stride() * s.width));
  }
  p1.setFrameBuffer(fb);
  p1.writePixels(s1.height);
}

// deepk = 0: one sample a pixel, planes as they are; else planes[0] holds
// the counts and planes[1 + c * K + k] sample k of channel c.
void write_deep(const Spec &s, std::vector<Plane> &planes, const char *out) {
  Header h = make_header(s);
  if (s.compression > ZIP_COMPRESSION) h.compression() = ZIPS_COMPRESSION;
  size_t n = size_t(s.width) * s.height;
  size_t k = s.deepk > 0 ? s.deepk : 1, off = s.deepk > 0 ? 1 : 0;
  std::vector<unsigned int> counts(n, 1);
  if (off)
    for (size_t i = 0; i < n; ++i) counts[i] = (unsigned int)planes[0].f[i];
  // each pixel's samples of a channel, one after another
  std::vector<Plane> samples(s.chans.size());
  std::vector<std::vector<char *>> ptrs(s.chans.size(), std::vector<char *>(n));
  for (size_t c = 0; c < s.chans.size(); ++c) {
    Plane &p = samples[c];
    p.type = s.chans[c].type;
    for (size_t i = 0; i < n; ++i)
      for (size_t j = 0; j < counts[i]; ++j) {
        Plane &src = planes[off + c * k + j];
        p.push(src.type == HALF ? float(src.h[i])
                                : src.type == FLOAT ? src.f[i] : float(src.u[i]));
      }
    size_t at = 0;
    for (size_t i = 0; i < n; ++i) {
      ptrs[c][i] = p.data() + at * p.stride();
      at += counts[i];
    }
  }
  DeepFrameBuffer fb;
  ptrdiff_t org = ptrdiff_t(s.ymin) * s.width + s.xmin;
  fb.insertSampleCountSlice(Slice(UINT, (char *)(counts.data() - org),
                                  sizeof(unsigned int),
                                  sizeof(unsigned int) * s.width));
  for (size_t c = 0; c < s.chans.size(); ++c)
    fb.insert(s.chans[c].name,
              DeepSlice(samples[c].type, (char *)(ptrs[c].data() - org),
                        sizeof(char *), sizeof(char *) * s.width,
                        samples[c].stride()));
  if (s.layout == "deepscanline") {
    h.setType(DEEPSCANLINE);
    DeepScanLineOutputFile f(out, h);
    f.setFrameBuffer(fb);
    f.writePixels(s.height);
  } else {
    h.setType(DEEPTILE);
    if (s.tx == 0) h.setTileDescription(TileDescription(8, 8, ONE_LEVEL));
    DeepTiledOutputFile f(out, h);
    f.setFrameBuffer(fb);
    f.writeTiles(0, f.numXTiles(0) - 1, 0, f.numYTiles(0) - 1, 0, 0);
  }
}

void write_yc(const Spec &s, std::vector<Plane> &planes, const char *out) {
  size_t n = size_t(s.width) * s.height;
  std::vector<Rgba> px(n);
  for (size_t i = 0; i < n; ++i) {
    auto get = [&](size_t c) {
      return planes[c].type == HALF ? float(planes[c].h[i]) : planes[c].f[i];
    };
    px[i] = Rgba(get(0), get(1), get(2), 1.0f);
  }
  Box2i dw(V2i(s.xmin, s.ymin), V2i(s.xmin + s.width - 1, s.ymin + s.height - 1));
  Header h(dw, dw);
  h.compression() = Compression(s.compression);
  if (s.chroma.size() == 8)
    addChromaticities(h, Chromaticities(V2f(s.chroma[0], s.chroma[1]),
                                        V2f(s.chroma[2], s.chroma[3]),
                                        V2f(s.chroma[4], s.chroma[5]),
                                        V2f(s.chroma[6], s.chroma[7])));
  RgbaOutputFile f(out, h, WRITE_YC);
  f.setFrameBuffer(px.data() - (ptrdiff_t(s.ymin) * s.width + s.xmin), 1,
                   s.width);
  f.writePixels(s.height);
}

int do_write(const char *out, const char *spec_path, const char *data_path) {
  Spec s = read_spec(spec_path);
  size_t n_planes = s.deepk > 0 ? 1 + s.chans.size() * s.deepk : s.chans.size();
  size_t n = size_t(s.width) * s.height * n_planes;
  std::vector<float> data(n);
  FILE *f = std::fopen(data_path, "rb");
  if (!f || std::fread(data.data(), 4, n, f) != n) {
    std::fprintf(stderr, "cannot read %s\n", data_path);
    return 1;
  }
  std::fclose(f);
  Spec flat = s;                   // the planes as FLOAT, one a plane
  if (s.deepk > 0)
    flat.chans.assign(n_planes, Chan{"", FLOAT});
  std::vector<Plane> planes = make_planes(s.deepk > 0 ? flat : s, data);
  if (s.layout == "yc") {
    write_yc(s, planes, out);
  } else if (s.layout == "multipart") {
    write_multipart(s, planes, out);
  } else if (s.layout == "deepscanline" || s.layout == "deeptiled") {
    write_deep(s, planes, out);
  } else if (s.tx > 0) {
    write_tiled(s, planes, out);
  } else {
    OutputFile o(out, make_header(s));
    o.setFrameBuffer(frame(s, planes));
    o.writePixels(s.height);
  }
  return 0;
}

int do_read(const char *in, const char *out) {
  try {
    InputFile f(in);
    Box2i dw = f.header().dataWindow();
    int w = dw.max.x - dw.min.x + 1, h = dw.max.y - dw.min.y + 1;
    const ChannelList &cl = f.header().channels();
    std::vector<std::string> names;
    std::vector<size_t> at;           // each plane's offset, in floats
    size_t total = 0;
    for (auto it = cl.begin(); it != cl.end(); ++it) {
      names.push_back(it.name());
      at.push_back(total);
      total += size_t(w / it.channel().xSampling) * (h / it.channel().ySampling);
    }
    std::vector<float> planes(total);
    FrameBuffer fb;
    size_t c = 0;
    for (auto it = cl.begin(); it != cl.end(); ++it, ++c) {
      int xs = it.channel().xSampling, ys = it.channel().ySampling;
      float *base = planes.data() + at[c] -
                    (ptrdiff_t(dw.min.y / ys) * (w / xs) + dw.min.x / xs);
      fb.insert(names[c], Slice(FLOAT, (char *)base, 4, 4 * size_t(w / xs),
                                xs, ys));
    }
    f.setFrameBuffer(fb);
    f.readPixels(dw.min.y, dw.max.y);
    FILE *o = std::fopen(out, "wb");
    std::fwrite(planes.data(), 4, planes.size(), o);
    std::fclose(o);
    std::printf("ok\n");
    for (auto it = cl.begin(); it != cl.end(); ++it)
      std::printf("%s %s %d %d\n", it.name(), type_name(it.channel().type),
                  it.channel().xSampling, it.channel().ySampling);
    std::printf("window %d %d %d %d\n", dw.min.x, dw.min.y, dw.max.x, dw.max.y);
  } catch (const std::exception &e) {
    std::printf("error %s\n", e.what());
    return 2;
  }
  return 0;
}

}  // namespace

int main(int argc, char **argv) {
  if (argc == 5 && std::string(argv[1]) == "write") {
    try {
      return do_write(argv[2], argv[3], argv[4]);
    } catch (const std::exception &e) {
      std::fprintf(stderr, "%s\n", e.what());
      return 1;
    }
  }
  if (argc == 4 && std::string(argv[1]) == "read") return do_read(argv[2], argv[3]);
  std::fprintf(stderr, "usage: exr_tool write OUT SPEC PLANES | read IN PLANES\n");
  return 1;
}
